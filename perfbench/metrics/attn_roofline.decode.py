"""The attention sublayer's decode calls: the least time the card needs
(its weights once, each live row's cache read to its length, the new
slot) over the device time launched inside ``blocks.Attention.decode``
under ``lm.decode_step``, in percent."""
from perfbench.harness import readings

SPANS = {"blocks.Attention.decode": "repro_torch.models.blocks:Attention.decode"}


def read(run):
    return readings.roofline(run, "attn", "decode", "lm.decode_step", "blocks.Attention.decode")
