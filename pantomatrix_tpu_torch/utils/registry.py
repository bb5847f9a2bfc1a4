"""String-driven class loading (counterpart of ``pantomatrix_tpu/utils/registry.py``, the
reference's ``init_class`` / ``init_hf_class``): a config names a class by its module
(``name_pyfile``) and ``class_name``, and these load it with importlib.
"""
from __future__ import annotations

import importlib
from typing import Any


def get_class(module_name: str, class_name: str) -> type:
    """The class ``class_name`` of module ``module_name``."""
    return getattr(importlib.import_module(module_name), class_name)


def init_class(module_name: str, class_name: str, *args, **kwargs) -> Any:
    """Import ``module_name`` and instantiate ``class_name`` with the given arguments."""
    return get_class(module_name, class_name)(*args, **kwargs)


def init_hf_class(module_name: str, class_name: str, pretrained_path: str, **kwargs) -> Any:
    """``class_name.from_pretrained(pretrained_path, **kwargs)``, the class found by name."""
    return get_class(module_name, class_name).from_pretrained(pretrained_path, **kwargs)


__all__ = ["get_class", "init_class", "init_hf_class"]
