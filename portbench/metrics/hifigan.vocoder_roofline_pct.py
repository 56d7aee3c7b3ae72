"""The HiFi-GAN's least time over the slice's decodes (the reference's
operations at each utterance's own length, ``hifigan_work.conversion``, at
the f32 peak of 67 TFLOP/s) over the device time of the decodes' events
(``paths/convert_hifigan.vocoder_device_s``): the MRF stacks' and the
up-convs' share of the roofline on the cuDNN route."""

LAYER = "HiFi-GAN vocoder"
UNIT = "%"
BETTER = "higher"
MOVES = "convert_audio_s_per_s"


def read(ctx):
    took = getattr(ctx, "vocoder_device_s", None)
    if not took:
        return None
    return 100.0 * ctx.vocoder_flops / ctx.peak_flops / took
