"""pantomatrix_tpu_torch — the PyTorch/CUDA port of pantomatrix_tpu for NVIDIA Hopper.

The JAX package ``pantomatrix_tpu`` is the reference this package is held against;
this package imports nothing of it (nor JAX). Each module mirrors its JAX
counterpart's path and names:

- ``core``    rotation math, joint masking, velocity integration
- ``nn``      layers, conv blocks, post-norm transformers, VQ lookup
- ``ops``     hand-written CUDA kernels (``csrc/``) with their plain PyTorch versions
- ``models``  EMAGE audio model and VQ tokenizer suite, ``from_pretrained`` API
- ``io``      checkpoint and BEAT-format npz IO
- ``data``    PCM WAV decode and resampling
- ``cli``     ``test_emage`` inference CLI

Parameters live in ``nn.Module`` trees whose ``state_dict`` paths equal the JAX
param-tree paths, so ``convert.py`` carries weights across with a strict load.
Activations at public functions are channels-last ``(B, L, C)``, as in the JAX package.
"""

__version__ = "0.1.0"
