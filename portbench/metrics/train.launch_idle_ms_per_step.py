"""ms a step that the device waited on the host inside the program's
``train.run`` spans of the slice (``train/graphs.StepRunner.run``: the
reseed, the learning-rate writes, the graph launches), from
``portbench/spans.py``."""

from portbench import spans

LAYER = "train step"
UNIT = "ms"
BETTER = "lower"
MOVES = "train_audio_s_per_s"


def read(ctx):
    return spans.within_ms_per_unit(ctx, "train", "train.run")
