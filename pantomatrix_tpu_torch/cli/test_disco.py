"""DisCo inference CLI on the GPU (counterpart of ``pantomatrix_tpu/cli/test_disco.py``):
the same arguments and output as the CaMN CLI.

    python -m pantomatrix_tpu_torch.cli.test_disco --audio_folder in/ --save_folder out/ \
        --model_path <checkpoint dir>      # or --random_init for a smoke run
"""
from __future__ import annotations


def main(argv=None) -> None:
    from ..models.api import DiscoAudioModel
    from ..models.configs import DiscoAudioConfig
    from .test_camn import build_parser, run

    run(build_parser().parse_args(argv), DiscoAudioModel, DiscoAudioConfig)


if __name__ == "__main__":
    main()
