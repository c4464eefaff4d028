"""The MLP's decode calls: the least time the card needs (its weights read
once) over the device time launched inside ``blocks.MLP.forward`` under
``lm.decode_step``, in percent."""
from perfbench.harness import readings

SPANS = {"blocks.MLP.forward": "repro_torch.models.blocks:MLP.forward"}


def read(run):
    return readings.roofline(run, "dense_mlp", "decode", "lm.decode_step", "blocks.MLP.forward")
