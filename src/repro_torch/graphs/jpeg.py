"""JPEG encoder STG (paper §III.B, Fig. 10, Tables 1-2).

Four producer/consumer kernels: Color Conversion -> DCT -> Quantization ->
Encoding, at 8x8-block granularity (one token = one 8x8 block of one
component).  Two layers:

  * the *published implementation library* (Table 1), fed verbatim to the
    trade-off finders to reproduce Table 2;
  * *functional* numpy kernels so transformed graphs can be simulated and
    checked for stream equivalence.

Copied from ``repro/graphs/jpeg.py``: plain Python and numpy, the names and
behaviour unchanged.
"""
from __future__ import annotations

import numpy as np

from ..core.stg import COMPUTE, SINK, SOURCE, STG, Impl, Node

# --- Table 1 (published implementation library) ---------------------------
TABLE1 = {
    "color": [("v1", 1, 512), ("v2", 2, 256), ("v3", 4, 128), ("v4", 8, 64)],
    "dct": [("v1", 1, 800), ("v2", 2, 400), ("v3", 4, 224), ("v4", 6, 160),
            ("v5", 32, 50)],
    "quant": [("v1", 1, 512), ("v2", 2, 256), ("v3", 4, 128), ("v4", 8, 64),
              ("v5", 128, 4)],
    "encode": [("v1", 512, 22)],
}

# Published Table 2 rows: v_tgt -> (ilp_total, heuristic_total)
TABLE2_TOTALS = {1: (23968, 13888), 2: (11920, 7456), 4: (5984, 3600), 8: (2976, 1736)}


def _impls(key: str) -> tuple[Impl, ...]:
    return tuple(Impl(name=n, area=a, ii=v) for (n, v, a) in TABLE1[key])


# --- functional kernels (token = float32 8x8 block) ------------------------
_QTABLE = np.array(  # standard JPEG luminance quantisation table
    [[16, 11, 10, 16, 24, 40, 51, 61],
     [12, 12, 14, 19, 26, 58, 60, 55],
     [14, 13, 16, 24, 40, 57, 69, 56],
     [14, 17, 22, 29, 51, 87, 80, 62],
     [18, 22, 37, 56, 68, 109, 103, 77],
     [24, 35, 55, 64, 81, 104, 113, 92],
     [49, 64, 78, 87, 103, 121, 120, 101],
     [72, 92, 95, 98, 112, 100, 103, 99]], dtype=np.float32)

_DCT_M = np.zeros((8, 8), dtype=np.float32)
for _k in range(8):
    for _n in range(8):
        _DCT_M[_k, _n] = np.cos(np.pi / 8 * (_n + 0.5) * _k)
_DCT_M[0] *= np.sqrt(1 / 8)
_DCT_M[1:] *= np.sqrt(2 / 8)

_ZIGZAG = sorted(((i, j) for i in range(8) for j in range(8)),
                 key=lambda p: (p[0] + p[1], p[1] if (p[0] + p[1]) % 2 else -p[1]))


def color_convert(block_rgb: np.ndarray) -> np.ndarray:
    """RGB (8,8,3) -> luma Y (8,8), BT.601."""
    r, g, b = block_rgb[..., 0], block_rgb[..., 1], block_rgb[..., 2]
    return (0.299 * r + 0.587 * g + 0.114 * b - 128.0).astype(np.float32)


def dct2(block: np.ndarray) -> np.ndarray:
    return (_DCT_M @ block @ _DCT_M.T).astype(np.float32)


def quantize(block: np.ndarray) -> np.ndarray:
    return np.round(block / _QTABLE).astype(np.int32)


def encode_rle(block: np.ndarray) -> tuple:
    """Zig-zag + run-length encode (DC kept verbatim); token = tuple."""
    zz = [int(block[i, j]) for (i, j) in _ZIGZAG]
    out = [zz[0]]
    run = 0
    for v in zz[1:]:
        if v == 0:
            run += 1
        else:
            out.append((run, v))
            run = 0
    out.append((0, 0))  # EOB
    return tuple(out)


def _pure(f):
    def fn(inputs, state):
        return [[f(inputs[0][0])]], state
    return fn


def build_stg() -> STG:
    g = STG()
    g.add_node(Node("camera", impls=(Impl("stream", area=0, ii=1e-9),),
                    kind=SOURCE, out_rates=(1,)))
    g.add_node(Node("color", impls=_impls("color"), fn=_pure(color_convert)))
    g.add_node(Node("dct", impls=_impls("dct"), fn=_pure(dct2)))
    g.add_node(Node("quant", impls=_impls("quant"), fn=_pure(quantize)))
    g.add_node(Node("encode", impls=_impls("encode"), fn=_pure(encode_rle)))
    g.add_node(Node("bitstream", impls=(Impl("sink", area=0, ii=1e-9),), kind=SINK))
    g.connect("camera", "color")
    g.connect("color", "dct")
    g.connect("dct", "quant")
    g.connect("quant", "encode")
    g.connect("encode", "bitstream")
    g.validate()
    return g


def random_blocks(n: int, seed: int = 0) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=(8, 8, 3)).astype(np.float32) for _ in range(n)]


def reference_pipeline(blocks: list[np.ndarray]) -> list:
    return [encode_rle(quantize(dct2(color_convert(b)))) for b in blocks]
