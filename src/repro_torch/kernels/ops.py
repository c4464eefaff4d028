"""Kernel dispatch: by the tensors' device, and by an explicit ``impl``.

  * ``impl=None`` (the default): the hand-written CUDA kernels.  Each
    wrapper launches its kernel for a CUDA tensor, and runs the kernel's
    plain version for a CPU tensor; nothing falls back from the card to
    the CPU.
  * ``impl="ref"``: the oracles of ``ref.py`` on either device (for the
    SSD scan, `ref.ssd_chunked`), and the op-by-op oracle body of
    `blocks.Attention.decode` — an explicit request, used to hold the
    kernel route against the oracle.

Unlike ``repro.kernels.ops`` there is no platform guess and no
environment variable: the device of the data decides.
"""
from __future__ import annotations

from . import ref
from .flash_attention import flash_attention as _flash_attention
from .fused_decode import attn_decode_step  # noqa: F401
from .rmsnorm import rmsnorm as _rmsnorm
from .ssd_scan import ssd_scan as _ssd_scan

IMPLS = (None, "ref")


def check_impl(impl: str | None) -> str | None:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    return impl


def attention(q, k, v, *, causal: bool = True, window: int | None = None,
              scale: float | None = None, kv_offset: int = 0,
              impl: str | None = None):
    """Multi-head (GQA) attention. q: (B,Sq,H,D), k/v: (B,Sk,KV,D)."""
    if check_impl(impl) == "ref":
        return ref.mha_reference(q, k, v, causal=causal, window=window,
                                 scale=scale, kv_offset=kv_offset)
    return _flash_attention(q, k, v, causal=causal, window=window, scale=scale,
                            kv_offset=kv_offset)


def ssd(x, dt, a, b, c, *, chunk: int = 128, impl: str | None = None):
    """Mamba2 SSD scan.  Returns (y, final_state).  ``chunk`` sets the
    blocking of the oracle and of the plain version on the CPU; the CUDA
    kernel walks the sequence in chunks of its own (64 tokens)."""
    if check_impl(impl) == "ref":
        return ref.ssd_chunked(x, dt, a, b, c, chunk=chunk)
    return _ssd_scan(x, dt, a, b, c, chunk=chunk)


def rmsnorm(x, w, *, eps: float = 1e-5, impl: str | None = None):
    if check_impl(impl) == "ref":
        return ref.rmsnorm_reference(x, w, eps=eps)
    return _rmsnorm(x, w, eps=eps)

