"""Layer tables for the paper's DNN benchmarks (Sec. VI-A, Table I).

Each layer is (kind, params) where conv = (cin, cout, k, h, w) with h, w
the *output* feature-map size at ImageNet 224x224 input, and fc =
(din, dout, tokens).
"""

from __future__ import annotations

from typing import List, Tuple

Layer = Tuple[str, tuple]


def _vgg(cfg_channels: List[tuple]) -> List[Layer]:
    layers: List[Layer] = []
    h = w = 224
    cin = 3
    for stage, (convs, cout) in enumerate(cfg_channels):
        for _ in range(convs):
            layers.append(("conv", (cin, cout, 3, h, w)))
            cin = cout
        h //= 2
        w //= 2
    layers += [("fc", (cin * 7 * 7, 4096, 1)),
               ("fc", (4096, 4096, 1)), ("fc", (4096, 1000, 1))]
    return layers


def vgg13():
    return _vgg([(2, 64), (2, 128), (2, 256), (2, 512), (2, 512)])


def vgg16():
    return _vgg([(2, 64), (2, 128), (3, 256), (3, 512), (3, 512)])


def vgg19():
    return _vgg([(2, 64), (2, 128), (4, 256), (4, 512), (4, 512)])


def msra(depth_cfg: List[tuple]) -> List[Layer]:
    """MSRA nets (He et al., "Delving deep into rectifiers"): 7x7,96
    stem then 3x3 stages up to 512 channels (paper Table I min/max:
    C7x7,3/96 and C3x3,512/512)."""
    layers: List[Layer] = [("conv", (3, 96, 7, 56, 56))]
    h = w = 28
    cin = 96
    for convs, cout in depth_cfg:
        for _ in range(convs):
            layers.append(("conv", (cin, cout, 3, h, w)))
            cin = cout
        h //= 2
        w //= 2
    layers += [("fc", (cin * 7 * 7, 4096, 1)),
               ("fc", (4096, 4096, 1)), ("fc", (4096, 1000, 1))]
    return layers


def msra1():
    return msra([(4, 256), (4, 512), (4, 512)])


def msra2():
    return msra([(6, 256), (6, 512), (6, 512)])


def _resnet_bottleneck(cin, mid, cout, h, w, stride_first=False):
    return [("conv", (cin, mid, 1, h, w)),
            ("conv", (mid, mid, 3, h, w)),
            ("conv", (mid, cout, 1, h, w))]


def resnet(blocks: List[int]) -> List[Layer]:
    layers: List[Layer] = [("conv", (3, 64, 7, 112, 112))]
    h = w = 56
    cin = 64
    for stage, n in enumerate(blocks):
        mid = 64 * 2 ** stage
        cout = mid * 4
        for b in range(n):
            layers += _resnet_bottleneck(cin, mid, cout, h, w)
            cin = cout
        h //= 2
        w //= 2
    layers.append(("fc", (2048, 1000, 1)))
    return layers


def resnet50():
    return resnet([3, 4, 6, 3])


def resnet101():
    return resnet([3, 4, 23, 3])


def bert_base(seq: int = 512) -> List[Layer]:
    layers: List[Layer] = []
    d, f = 768, 3072
    for _ in range(12):
        for _ in range(4):                       # q, k, v, out projections
            layers.append(("fc", (d, d, seq)))
        layers.append(("fc", (d, f, seq)))       # feed-forward up
        layers.append(("fc", (f, d, seq)))       # feed-forward down
    return layers


def autoencoder() -> List[Layer]:
    """Hinton's MNIST autoencoder: 784-1000-500-250-30 and mirror."""
    dims = [784, 1000, 500, 250, 30, 250, 500, 1000, 784]
    return [("fc", (a, b, 1)) for a, b in zip(dims[:-1], dims[1:])]


NETS = {
    "vgg13": vgg13, "vgg16": vgg16, "vgg19": vgg19,
    "msra1": msra1, "msra2": msra2,
    "resnet50": resnet50, "resnet101": resnet101,
    "bert": bert_base, "autoencoder": autoencoder,
}


def soi_factors(layer: Layer) -> Tuple[int, int]:
    """K-FAC factor dims (A, G) for a layer (paper Sec. II-A):
    conv: A = cin*k^2, G = cout; fc: A = din, G = dout."""
    kind, p = layer
    if kind == "conv":
        cin, cout, k, h, w = p
        return cin * k * k, cout
    din, dout, _ = p
    return din, dout


def soi_blocks(dim: int, block: int = 1024) -> Tuple[int, int]:
    """Paper Table I format: b full blocks of `block` + one r x r rest."""
    return dim // block, dim % block


def layer_flops(layer: Layer) -> float:
    """Forward MACs."""
    kind, p = layer
    if kind == "conv":
        cin, cout, k, h, w = p
        return cin * k * k * cout * h * w
    din, dout, tokens = p
    return din * dout * tokens
