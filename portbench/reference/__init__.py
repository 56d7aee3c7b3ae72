"""The benchmark's plain reference: MaskCycleGAN-VC and the melgan-neurips
generator in plain PyTorch, float32, with no kernels, no batching of
forwards and no CUDA graphs.

It follows the published code (GANtastic3/MaskCycleGAN-VC ``model.py`` and
``train.py``; descriptinc/melgan-neurips ``mel2wav/modules.py``) and takes
parameters by the same names, so that the benchmark can hand one set of
seeded weights to both the program and this reference. It imports nothing
of the program under test.
"""
