"""Bit-sliced matrix product on Hopper: wrapper of ``csrc/bitslice_mm.cu``.

Replaces the Pallas TPU kernel ``repro.kernels.bitslice_mm``:
fp32-accurate ``a @ b`` as ``a_hi@b_hi + a_hi@b_lo + a_lo@b_hi`` of
bf16 slices split inside the kernel, accumulated in fp32 on the tensor
cores. The CUDA source states what bounds it and how the design answers
that.

Unlike the TPU kernel, ragged M, N and K are masked in the kernel, not
zero-padded to the block grid on the host. The plain version is
:func:`repro_torch.kernels.ref.bitslice_mm_ref`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import CudaLibrary

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P, _P, _P, _I, _I, _I, _P]
#: input dtype -> C launch function
_ENTRY = {torch.float32: "bitslice_mm_f32_launch",
          torch.float16: "bitslice_mm_f16_launch",
          torch.bfloat16: "bitslice_mm_bf16_launch"}
LIB = CudaLibrary("bitslice_mm", "bitslice_mm.cu",
                  {sym: _ARGS for sym in _ENTRY.values()})


def bitslice_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """fp32 ``a @ b`` for contiguous (M, K) and (K, N) CUDA matrices of
    float32, float16 or bfloat16 (operands of different dtypes are
    both upcast to float32 first, which is exact)."""
    for name, t in (("a", a), ("b", b)):
        if not t.is_cuda:
            raise ValueError(f"bitslice_mm kernel needs CUDA tensors; {name} "
                             f"is on {t.device}")
        if t.dtype not in _ENTRY:
            raise ValueError(f"bitslice_mm kernel takes float32, float16 or "
                             f"bfloat16; {name} is {t.dtype}")
        if t.ndim != 2:
            raise ValueError(f"bitslice_mm takes matrices; {name} has shape "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"bitslice_mm kernel needs contiguous tensors; "
                             f"{name} is not")
    if a.device != b.device:
        raise ValueError("bitslice_mm operands are on different devices")
    (m, k), (k2, n) = a.shape, b.shape
    if k != k2:
        raise ValueError(f"bitslice_mm shapes disagree: a {tuple(a.shape)}, "
                         f"b {tuple(b.shape)}")
    if a.dtype != b.dtype:
        a, b = a.to(torch.float32), b.to(torch.float32)
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out
    if k == 0:
        return out.zero_()
    with torch.cuda.device(a.device):
        LIB.launch(_ENTRY[a.dtype], a.data_ptr(), b.data_ptr(),
                   out.data_ptr(), m, n, k,
                   torch.cuda.current_stream(a.device).cuda_stream)
    return out
