"""pantomatrix_tpu_torch — the PyTorch/CUDA port of pantomatrix_tpu for NVIDIA Hopper.

The JAX package ``pantomatrix_tpu`` is the reference this package is held against;
this package imports nothing of it (nor JAX). Each module mirrors its JAX
counterpart's path and names:

- ``core``    rotation math, joint masking, velocity integration, SMPL-X forward
              kinematics and the motion representations built on it
- ``nn``      layers, conv blocks, post-norm transformers, VQ lookup, the LSTM
- ``ops``     hand-written CUDA kernels (``csrc/``) with their plain PyTorch versions
- ``models``  EMAGE audio model and VQ tokenizer suite, CaMN, DisCo, the
              ``from_pretrained`` API and ``AutoModel``
- ``utils``   the low-precision serving mode's parameter cast, the train configs'
              reader (a YAML subset, DotDict, overrides)
- ``io``      checkpoint and BEAT-format npz IO
- ``data``    WAV and MP3 decode and resampling, the BEAT2 clip index, the BEAT2
              train datasets and loaders, the device-resident loader
- ``eval``    the evaluation metrics (FGD with its AESKConv encoder, BC, L1div, LVD,
              MSE), the metric pipeline and the test-set pass
- ``train``   losses, the optimizer and schedules, the train steps, the loop,
              checkpoints and run records
- ``configs`` the train CLIs' YAML configs
- ``native``  the libmpg123 MP3 binding
- ``cli``     ``test_emage``, ``test_camn`` and ``test_disco`` inference CLIs, the
              serving daemon and its load generator, ``evaluate``, and the
              ``train_emage``, ``train_camn`` and ``train_disco`` trainers

Parameters live in ``nn.Module`` trees whose ``state_dict`` paths equal the JAX
param-tree paths, so ``convert.py`` carries weights across with a strict load.
Activations at public functions are channels-last ``(B, L, C)``, as in the JAX package.
"""

__version__ = "0.1.0"
