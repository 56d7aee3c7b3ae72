"""Seconds of the program's ``train.create_state`` span
(``train/state.create_train_state``: both generators, the four
discriminators and the Adams, drawn on the host) before the window."""

from portbench import spans

LAYER = "train state"
UNIT = "s"
BETTER = "lower"
MOVES = "setup_s"


def read(ctx):
    return spans.setup_s(ctx, "train.create_state")
