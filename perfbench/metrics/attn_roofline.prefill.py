"""The attention sublayer in prefill: the least time the card needs (the
projections' and the causal attention's FLOPs over the real prompt
tokens, or the bytes if larger) over the device time launched inside
``blocks.Attention.forward`` under ``lm.prefill``, in percent."""
from perfbench.harness import readings

SPANS = {"blocks.Attention.forward": "repro_torch.models.blocks:Attention.forward"}


def read(run):
    return readings.roofline(run, "attn", "prefill", "lm.prefill", "blocks.Attention.forward")
