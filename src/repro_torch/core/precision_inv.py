"""High-precision matrix inversion composed from low-precision primitives
(counterpart of ``repro.core.precision_inv``; RePAST Sec. III).

Two implementations live here:

1. The behavioural circuit model (NumPy, float64 carrier):
   ``faithful_inv_apply`` and ``faithful_fused_gram_inv_apply``. The INV
   crossbar stores only the top ``k*R_c`` bits of ``A`` (``A_H``), DACs
   deliver ``R_DAC``-bit input slices, ADCs emit ``R_ADC`` bits per
   conversion, and the three nested loops of Fig. 4(a) — Loop b (DAC
   slicing, Eqn. 6), Loop x (ADC residual refinement) and Loop A (the
   Taylor/Neumann series over the ``A_H/A_L`` split, Eqn. 8/9) — compose
   a >=16-bit accurate solve. It needs no torch: the same float64 code
   as the reference, so both give the same bits.

2. The tensor-core dialect: ``composed_inverse`` — Newton–Schulz on the
   bf16 hi slice ``A_H`` plays the low-precision INV crossbar, a Neumann
   series over ``A_L`` is Loop A, and refinement against the full ``A``
   recovers the bits the low-precision primitive lost — and
   ``mxu_inv_apply``, which applies that inverse through the
   ``bitslice_mm`` kernel (``kernels.ops``). The training path runs the
   same inverse through the ``neumann_inv`` kernel, whose ``X0``
   normalisation ``A_H/(n1·ninf)`` differs from the
   ``A_H/sqrt(n1·ninf)**2`` here at rounding level only.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core.quantize import (
    CircuitConfig,
    hilo_matmul,
    hilo_matmul_exact_lhs,
    split_hi_lo_bf16,
)
from repro_torch.kernels import ops

__all__ = [
    "CircuitConfig",
    "quantize_problem",
    "faithful_inv_apply",
    "faithful_fused_gram_inv_apply",
    "achieved_bits",
    "newton_schulz_inverse",
    "composed_inverse",
    "mxu_inv_apply",
]


# ---------------------------------------------------------------------------
# Behavioural circuit model (NumPy / float64 carrier)
# ---------------------------------------------------------------------------

def _quant(x: np.ndarray, bits: int, scale: float) -> np.ndarray:
    # symmetric clip: the sign/magnitude converters have no -2**bits code
    step = scale * 2.0 ** (-bits)
    q = np.round(x / step)
    np.clip(q, -(2.0 ** bits - 1), 2.0 ** bits - 1, out=q)
    return q * step


def _pow2_range(x: np.ndarray) -> float:
    """Auto-ranging converter scale: smallest power of two >= max|x|.

    Models the programmable-gain stage in front of the ADC (the paper's
    shift alignment between loop iterations keeps signals in range)."""
    m = float(np.max(np.abs(x)))
    if m == 0.0 or not np.isfinite(m):
        return 1.0
    return float(2.0 ** np.ceil(np.log2(m)))


def _adc(x: np.ndarray, cfg: CircuitConfig) -> np.ndarray:
    """R_ADC-bit conversion at an auto-ranged power-of-two scale."""
    return _quant(x, cfg.r_adc, _pow2_range(x))


def _split_hi_lo(A: np.ndarray, total_bits: int, hi_bits: int, scale: float):
    """Round-to-nearest hi/lo split. Rounding (not truncation) keeps the
    residue ``A_L`` zero-mean and signed, which is what makes the Neumann
    series contract (||A - A_H|| ~ sqrt(n) 2^-hi instead of n 2^-hi).
    Signed cell values are realized with differential crossbar pairs."""
    Aq = _quant(A, total_bits, scale)
    step_hi = scale * 2.0 ** (-hi_bits)
    hi = np.round(Aq / step_hi) * step_hi
    lo = (Aq - hi) * 2.0 ** hi_bits
    return hi, lo


def _analog_inv_crossbar(A_H_lu, b: np.ndarray, cfg: CircuitConfig) -> np.ndarray:
    """One pass through the INV crossbar array: the analog OpAmp feedback
    settles to the exact solution of ``A_H x = b`` (paper Eqn. 4/5); the
    only loss is the output conversion, R_ADC bits at an auto-ranged
    scale."""
    import scipy.linalg as sla

    x = sla.lu_solve(A_H_lu, b)
    return _adc(x, cfg)


def _hp_vmm(M: np.ndarray, v: np.ndarray, cfg: CircuitConfig) -> np.ndarray:
    """High-precision bit-sliced VMM (ISAAC-style, paper Sec. II-B). With
    both operands on fixed-point grids the per-slice partial products are
    small integers and the digital S+A accumulators are wide, so the
    composed product is exact: the precision limiters of this model are
    the operand grids, not the VMM."""
    return M @ v


def _loop_b_solve(A_H_lu, r: np.ndarray, cfg: CircuitConfig,
                  rhs_scale: float) -> np.ndarray:
    """Loop b (Eqn. 6): slice the rhs into R_DAC-bit DAC inputs, solve each
    slice on the INV crossbar, shift-and-add the ADC outputs."""
    step = rhs_scale * 2.0 ** (-cfg.q_b)
    q = np.round(r / step)
    # symmetric clip: code -2**q_b would need q_b + 1 magnitude bits and
    # the loops_b slices below would silently drop its top bit, turning a
    # DAC-grid-saturating rhs component into 0 (and Loop x can never
    # recover it: the residual re-saturates at every rescale)
    np.clip(q, -(2.0 ** cfg.q_b - 1), 2.0 ** cfg.q_b - 1, out=q)
    sign = np.sign(q)
    mag = np.abs(q)
    acc = np.zeros_like(r)
    for i in range(cfg.loops_b):
        sl = sign * np.mod(mag, 2.0 ** cfg.r_dac)          # R_DAC-bit slice
        mag = np.floor(mag / 2.0 ** cfg.r_dac)
        # slice is worth  sl * 2**(i*r_dac) * step  in real units
        sl_val = sl * (2.0 ** (i * cfg.r_dac)) * step
        acc = acc + _analog_inv_crossbar(A_H_lu, sl_val, cfg)
    return acc


def _loop_x_solve(A_H_lu, vmm_a, b: np.ndarray, cfg: CircuitConfig,
                  scale: float) -> np.ndarray:
    """Loop x: iterative residual refinement around the ADC. Each round
    quantizes ~R_ADC more bits of x:
    ``x_j = ADC(A_H^{-1} b_j)``;  ``b_{j+1} = (b_j - A x_j) * 2^{R_ADC}``.
    The residual uses the full matrix (``vmm_a``: ``A_H`` on the INV
    crossbars plus ``A_L`` on its VMM crossbar, paper Sec. III-A.2), so
    the refinement contracts toward the true solution."""
    x_acc = np.zeros_like(b)
    r = b
    for j in range(cfg.loops_x):
        xj = _loop_b_solve(A_H_lu, r, cfg, rhs_scale=_pow2_range(r))
        x_acc = x_acc + xj * 2.0 ** (-j * cfg.r_adc)
        r = (r - vmm_a(xj)) * 2.0 ** cfg.r_adc
    return x_acc


def quantize_problem(
    A: np.ndarray, b: np.ndarray, cfg: CircuitConfig = CircuitConfig()
) -> Tuple[np.ndarray, np.ndarray]:
    """The Q_A/Q_b-bit view of the problem the circuit actually solves;
    its exact solution is the paper's accuracy yardstick (Fig. 4(b):
    "matrix, input vector and result are all 16-bit quantized")."""
    A = np.asarray(A, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    s_A = float(np.max(np.abs(A))) or 1.0
    A_H, A_L = _split_hi_lo(A, cfg.q_a, cfg.hi_bits, s_A)
    Aq = A_H + A_L * 2.0 ** (-cfg.hi_bits)
    bq = _quant(b, cfg.q_b, _pow2_range(b))
    return Aq, bq


def faithful_inv_apply(
    A: np.ndarray,
    b: np.ndarray,
    cfg: CircuitConfig = CircuitConfig(),
    return_trace: bool = False,
) -> np.ndarray | Tuple[np.ndarray, list]:
    """Solve ``x = A^{-1} b`` with the full three-loop RePAST scheme.

    ``A``: (n, n) symmetric (Tikhonov-damped SOI block); ``b``: (n,) or
    (n, m). Converges iff the Neumann series contracts,
    ``rho(A_H^{-1}(A - A_H)) < 1`` (Sec. III-A.3). With
    ``return_trace``, also returns the partial solution after each
    Loop-A iteration (Fig. 4(b))."""
    import scipy.linalg as sla

    A = np.asarray(A, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    s_A = float(np.max(np.abs(A))) or 1.0
    A_H, A_L = _split_hi_lo(A, cfg.q_a, cfg.hi_bits, s_A)
    b = _quant(b, cfg.q_b, _pow2_range(b))
    A_H_lu = sla.lu_factor(A_H)

    def vmm_a(x):
        # full-matrix VMM: A_H (INV crossbars, VMM-wired) + A_L (VMM xbar)
        return _hp_vmm(A_H, x, cfg) + _hp_vmm(A_L, x, cfg) * 2.0 ** (-cfg.hi_bits)

    # Loop A in its error-feedback form (x <- x + LoopX(r); r <- r - A x_l):
    # the recurrence expands to the alternating series of Eqn. 9 while
    # keeping every intermediate in converter range.
    def out_reg(x):
        # the accumulated result lives in a Q_x-bit output register
        return _quant(x, cfg.q_x, _pow2_range(x))

    x_acc = np.zeros_like(b)
    r = b
    trace = []
    for _ in range(cfg.n_taylor):
        x_l = _loop_x_solve(A_H_lu, vmm_a, r, cfg, scale=_pow2_range(r))
        x_acc = x_acc + x_l
        if return_trace:
            trace.append(out_reg(x_acc))
        r = r - vmm_a(x_l)
    x_acc = out_reg(x_acc)
    if return_trace:
        return x_acc, trace
    return x_acc


def faithful_fused_gram_inv_apply(
    a: np.ndarray,
    b: np.ndarray,
    damping: float,
    cfg: CircuitConfig = CircuitConfig(),
) -> np.ndarray:
    """Fused MM+INV (paper Sec. IV-B, Eqn. 11-13): solve
    ``x = (a a^T + damping I)^{-1} b`` without materializing the Gram at
    full precision. ``a``: (n, m). The hi/lo split is applied to the
    factors: ``A_H = a_H a_H^T + damping I`` on the fused INV crossbars,
    the rest on VMM crossbars (Eqn. 13 with both cross terms kept). The
    ``fused_gram_inv`` kernel is the tensor-core form of the same
    fusion."""
    import scipy.linalg as sla

    a = np.asarray(a, dtype=np.float64)
    s_a = float(np.max(np.abs(a))) or 1.0
    a_H, a_L = _split_hi_lo(a, cfg.q_a, cfg.hi_bits, s_a)
    a_L = a_L * 2.0 ** (-cfg.hi_bits)  # back to real units for the model
    A_H = a_H @ a_H.T + damping * np.eye(a.shape[0])
    A_H_lu = sla.lu_factor(A_H)

    aq = a_H + a_L  # the Q_A-bit view of a

    def vmm_a(x):
        # A x = a (a^T x) + damp x as two chained bit-sliced VMMs
        return _hp_vmm(aq, _hp_vmm(aq.T, x, cfg), cfg) + damping * x

    x_acc = np.zeros_like(b, dtype=np.float64)
    r = np.asarray(b, dtype=np.float64)
    for _ in range(cfg.n_taylor):
        x_l = _loop_x_solve(A_H_lu, vmm_a, r, cfg, scale=_pow2_range(r))
        x_acc = x_acc + x_l
        r = r - vmm_a(x_l)
    return x_acc


def achieved_bits(x: np.ndarray, x_ref: np.ndarray) -> float:
    """Relative accuracy of ``x`` vs ``x_ref`` in bits: -log2(relerr)."""
    num = float(np.max(np.abs(x - x_ref)))
    den = float(np.max(np.abs(x_ref))) or 1.0
    if num == 0:
        return 64.0
    return float(-np.log2(num / den))


# ---------------------------------------------------------------------------
# Tensor-core dialect (bf16 hi/lo primitives)
# ---------------------------------------------------------------------------

def _norm_bound(a: torch.Tensor) -> torch.Tensor:
    """Per-block bound on ``||A||_2``: ``sqrt(||A||_1 ||A||_inf)``."""
    n1 = a.abs().sum(dim=-2).amax(dim=-1)
    ninf = a.abs().sum(dim=-1).amax(dim=-1)
    return torch.sqrt(n1 * ninf)


def newton_schulz_inverse(a: torch.Tensor, n_iters: int = 18, *,
                          hilo: bool = True,
                          exact_bf16: bool = False) -> torch.Tensor:
    """``X <- X (2I - A X)`` from ``X0 = A / ||A||^2`` on (..., n, n)."""
    a = a.to(torch.float32)
    n = a.shape[-1]
    eye = torch.eye(n, dtype=torch.float32, device=a.device)
    x = a / (_norm_bound(a) ** 2)[..., None, None]
    mm = hilo_matmul if hilo else torch.matmul
    if hilo and exact_bf16:
        a16 = a.to(torch.bfloat16)
        mm_a = hilo_matmul_exact_lhs
    else:
        a16, mm_a = a, mm
    for _ in range(n_iters):
        x = mm(x, 2.0 * eye - mm_a(a16, x))
    return x


def composed_inverse(a: torch.Tensor, damping=0.0, *, ns_iters: int = 18,
                     taylor_terms: int = 4,
                     refine_steps: int = 1) -> torch.Tensor:
    """``(A + damping I)^{-1}`` on (..., n, n) blocks; ``damping`` is a
    scalar or broadcasts against the batch dims."""
    a = a.to(torch.float32)
    n = a.shape[-1]
    eye = torch.eye(n, dtype=torch.float32, device=a.device)
    lam = torch.as_tensor(damping, dtype=torch.float32, device=a.device)
    ad = a + lam[..., None, None] * eye
    a_hi16, a_lo16 = split_hi_lo_bf16(ad)
    y = newton_schulz_inverse(a_hi16.to(torch.float32), ns_iters,
                              hilo=True, exact_bf16=True)
    m, t = y, y
    for _ in range(max(taylor_terms - 1, 0)):
        t = -hilo_matmul(y, hilo_matmul_exact_lhs(a_lo16, t))
        m = m + t
    for _ in range(refine_steps):
        m = m + hilo_matmul(m, eye - hilo_matmul(ad, m))
    return m


def mxu_inv_apply(a: torch.Tensor, b: torch.Tensor, damping=0.0,
                  **kw) -> torch.Tensor:
    """Solve ``(A + damping I)^{-1} B`` for an (n, n) ``A`` and (n, m)
    ``B``: the composed inverse, then its product with ``B`` through
    ``ops.bitslice_mm`` (the reference's ``hilo_matmul(M, B)``: on CPU
    tensors bitwise that plain product, on CUDA tensors the kernel)."""
    m = composed_inverse(a, damping, **kw)
    return ops.bitslice_mm(m, b.to(torch.float32).contiguous())
