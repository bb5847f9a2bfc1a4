"""The port's string-driven class loading (pantomatrix_tpu_torch/utils/registry.py): every
``name_pyfile`` / ``class_name`` pair of the shipped configs loads through it, and a tiny
model is built by name on the CPU and reloaded by ``init_hf_class``."""
import glob
import os

import pytest
import torch

from pantomatrix_tpu_torch.utils.config import load_yaml
from pantomatrix_tpu_torch.utils.registry import get_class, init_class, init_hf_class

torch.set_num_threads(2)

CONFIGS = sorted(glob.glob(os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "pantomatrix_tpu_torch", "configs", "*.yaml")))


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_every_config_class_loads(path):
    cfg = load_yaml(path)
    pairs = [(cfg[s].name_pyfile, cfg[s].class_name) for s in ("model", "data")]
    assert all(mod.startswith("pantomatrix_tpu_torch.") for mod, _ in pairs)
    for mod, name in pairs:
        cls = get_class(mod, name)
        assert isinstance(cls, type) and cls.__name__ == name and cls.__module__.startswith(
            "pantomatrix_tpu_torch.")


def test_init_class_builds_a_tiny_model_and_init_hf_class_reloads_it(tmp_path):
    from pantomatrix_tpu_torch.models.api import CamnAudioModel
    from pantomatrix_tpu_torch.models.configs import CamnAudioConfig

    cfg = CamnAudioConfig(hidden_size=32, n_layer=1, dropout_prob=0.0)
    model = init_class("pantomatrix_tpu_torch.models.api", "CamnAudioModel", cfg, seed=3,
                       device="cpu")
    assert isinstance(model, CamnAudioModel) and model.config.hidden_size == 32
    model.save_pretrained(str(tmp_path))
    again = init_hf_class("pantomatrix_tpu_torch.models.api", "CamnAudioModel", str(tmp_path),
                          device="cpu")
    for (k, a), (_, b) in zip(model.state_dict().items(), again.state_dict().items()):
        assert torch.equal(a, b), k
    with pytest.raises(AttributeError):
        get_class("pantomatrix_tpu_torch.models.api", "NoSuchModel")
