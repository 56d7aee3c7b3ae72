"""The least time of the slice's K1-K5 launches
(``bounds.train_step_sites``, ``bounds.bound_s``) over their device
time."""

from portbench import layer

LAYER = "norm kernels K1-K5"
UNIT = "%"
BETTER = "higher"
MOVES = "train_audio_s_per_s"


def read(ctx):
    return layer.roofline_pct(ctx, ("in_glu", "in", "in_swish", "ps_in_swish", "ps_in_swish_bwd"))
