"""StreamIt-style benchmarks (paper §III.A): FFT, FilterBank, Autocor.

Each benchmark is a KPN/STG with functional numpy node bodies plus an
implementation library generated by the Intra-Node Optimizer over a
primitive-op DAG of the node's inner loop — the paper used these small
graphs to validate the front-end (implementation finding) and the
simulator; we do the same in tests/benchmarks.

Copied from ``repro/graphs/streamit.py``: plain Python and numpy, the names and
behaviour unchanged.
"""
from __future__ import annotations

import numpy as np

from ..core.intra_node import CompositeBody, PrimOp, enumerate_impls
from ..core.stg import SINK, SOURCE, STG, Impl, Node


def _src(name="src"):
    return Node(name, impls=(Impl("stream", area=0, ii=1e-9),), kind=SOURCE)


def _sink(name="out"):
    return Node(name, impls=(Impl("sink", area=0, ii=1e-9),), kind=SINK)


def _pure(f):
    def fn(inputs, state):
        return [[f(inputs[0][0])]], state
    return fn


def _pure2(f):
    def fn(inputs, state):
        return [[f(inputs[0][0], inputs[1][0])]], state
    return fn


# --- FFT (radix-2, N=8): 3 butterfly stages + bit-reversal -----------------
def _butterfly_body(n_bf: int) -> CompositeBody:
    ops = []
    for k in range(n_bf):
        ops += [
            PrimOp(f"tw{k}", "mul"),                      # twiddle multiply (complex ~ mul)
            PrimOp(f"add{k}", "add", (f"tw{k}",)),
            PrimOp(f"sub{k}", "sub", (f"tw{k}",)),
        ]
    return CompositeBody(ops=tuple(ops))


def _fft_stage(n: int, stage: int):
    """One radix-2 stage over a length-n block (token = complex vector)."""
    half = 1 << stage
    def f(x: np.ndarray) -> np.ndarray:
        x = x.reshape(-1, 2 * half)
        w = np.exp(-2j * np.pi * np.arange(half) / (2 * half))
        a, b = x[:, :half], x[:, half:] * w
        return np.concatenate([a + b, a - b], axis=1).reshape(-1)
    return f


def _bitrev(n: int):
    bits = n.bit_length() - 1
    idx = np.array([int(format(i, f"0{bits}b")[::-1], 2) for i in range(n)])
    def f(x: np.ndarray) -> np.ndarray:
        return x[idx]
    return f


def build_fft(n: int = 8) -> STG:
    g = STG()
    g.add_node(_src())
    g.add_node(Node("bitrev", impls=tuple(enumerate_impls(
        CompositeBody(ops=tuple(PrimOp(f"c{i}", "copy") for i in range(n))))),
        fn=_pure(_bitrev(n))))
    prev = "bitrev"
    stages = int(np.log2(n))
    for s in range(stages):
        name = f"bf{s}"
        g.add_node(Node(name, impls=tuple(enumerate_impls(_butterfly_body(n // 2))),
                        fn=_pure(_fft_stage(n, s))))
        g.connect(prev, name)
        prev = name
    g.add_node(_sink())
    g.connect("src", "bitrev")
    g.connect(prev, "out")
    g.validate()
    return g


def fft_reference(blocks: list[np.ndarray]) -> list[np.ndarray]:
    return [np.fft.fft(b) for b in blocks]


# --- FilterBank: analysis branches + combine --------------------------------
def _fir_body(taps: int) -> CompositeBody:
    ops = [PrimOp("m0", "mul")]
    for k in range(1, taps):
        ops.append(PrimOp(f"m{k}", "mul"))
        ops.append(PrimOp(f"a{k}", "add", (f"m{k}", f"m{k-1}" if k == 1 else f"a{k-1}")))
    return CompositeBody(ops=tuple(ops))


def _fir(taps: np.ndarray):
    def f(x: np.ndarray) -> np.ndarray:
        return np.convolve(x, taps, mode="same").astype(np.float64)
    return f


def build_filterbank(branches: int = 4, taps: int = 8) -> STG:
    g = STG()
    g.add_node(_src())
    rng = np.random.default_rng(7)
    # duplicating splitter: every branch sees the full block
    def dup(inputs, state):
        return [[inputs[0][0]] for _ in range(branches)], state
    g.add_node(Node("split", impls=(Impl("dup", area=1, ii=1),),
                    out_rates=(1,) * branches, fn=dup))
    g.connect("src", "split")
    lib = tuple(enumerate_impls(_fir_body(taps)))
    coefs = [rng.normal(size=taps) for _ in range(branches)]
    for b in range(branches):
        g.add_node(Node(f"fir{b}", impls=lib, fn=_pure(_fir(coefs[b]))))
        g.connect("split", f"fir{b}", src_port=b)
    def comb(inputs, state):
        return [[np.sum([inputs[b][0] for b in range(branches)], axis=0)]], state
    g.add_node(Node("combine", impls=tuple(enumerate_impls(CompositeBody(
        ops=tuple(PrimOp(f"a{i}", "add") for i in range(branches - 1))))),
        in_rates=(1,) * branches, fn=comb))
    for b in range(branches):
        g.connect(f"fir{b}", "combine", dst_port=b)
    g.add_node(_sink())
    g.connect("combine", "out")
    g.validate()
    g._filterbank_coefs = coefs  # stash for reference computation
    return g


def filterbank_reference(g: STG, blocks: list[np.ndarray]) -> list[np.ndarray]:
    coefs = g._filterbank_coefs
    return [np.sum([np.convolve(b, c, mode="same") for c in coefs], axis=0)
            for b in blocks]


# --- Autocor: K lag-products + normalise -----------------------------------
def build_autocor(lags: int = 4, n: int = 16) -> STG:
    g = STG()
    g.add_node(_src())
    def dup(inputs, state):
        return [[inputs[0][0]] for _ in range(lags)], state
    g.add_node(Node("split", impls=(Impl("dup", area=1, ii=1),),
                    out_rates=(1,) * lags, fn=dup))
    g.connect("src", "split")
    lib = tuple(enumerate_impls(CompositeBody(ops=tuple(
        [PrimOp(f"m{i}", "mac") for i in range(n)]))))
    for k in range(lags):
        def mk(k):
            def f(x: np.ndarray) -> float:
                return float(np.dot(x[:len(x) - k], x[k:]))
            return f
        g.add_node(Node(f"lag{k}", impls=lib, fn=_pure(mk(k))))
        g.connect("split", f"lag{k}", src_port=k)
    def gather(inputs, state):
        return [[np.array([inputs[k][0] for k in range(lags)])]], state
    g.add_node(Node("gather", impls=(Impl("v1", area=lags, ii=1),),
                    in_rates=(1,) * lags, fn=gather))
    for k in range(lags):
        g.connect(f"lag{k}", "gather", dst_port=k)
    g.add_node(_sink())
    g.connect("gather", "out")
    g.validate()
    return g


def autocor_reference(blocks: list[np.ndarray], lags: int = 4) -> list[np.ndarray]:
    return [np.array([float(np.dot(b[:len(b) - k], b[k:])) for k in range(lags)])
            for b in blocks]
