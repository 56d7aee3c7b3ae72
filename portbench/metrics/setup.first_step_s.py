"""Seconds of the program's ``train.first_step`` spans
(``train/graphs.StepRunner._first_step``: a variant's eager step and its
capture, kernel loads included) before the window, summed over variants."""

from portbench import spans

LAYER = "train step"
UNIT = "s"
BETTER = "lower"
MOVES = "setup_s"


def read(ctx):
    return spans.setup_s(ctx, "train.first_step")
