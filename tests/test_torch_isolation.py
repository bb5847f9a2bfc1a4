"""The port stands alone: pantomatrix_tpu_torch, chip_smoke.py and the port's profile
scripts import neither JAX nor the JAX package, directly or through anything they
import."""
import ast
import glob
import os
import subprocess
import sys

import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "pantomatrix_tpu_torch")


def _is_forbidden(name: str) -> bool:
    # "pantomatrix_tpu_torch".startswith("pantomatrix_tpu") is true: match exactly
    return (name == "jax" or name.startswith("jax.") or name == "jaxlib"
            or name.startswith("jaxlib.") or name == "pantomatrix_tpu"
            or name.startswith("pantomatrix_tpu."))


def _port_files():
    # chip_smoke.py runs the tiny multi-process runs of tests/_torch_mp_runs.py
    files = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "tests", "_torch_mp_runs.py")]
    files += sorted(glob.glob(os.path.join(REPO, "scripts", "torch_*.py")))
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return files


def test_forbidden_name_check_tells_the_packages_apart():
    assert _is_forbidden("pantomatrix_tpu") and _is_forbidden("pantomatrix_tpu.ops.vq_pallas")
    assert _is_forbidden("jax") and _is_forbidden("jax.numpy")
    assert not _is_forbidden("pantomatrix_tpu_torch")
    assert not _is_forbidden("pantomatrix_tpu_torch.ops.vq_cuda")
    assert not _is_forbidden("jaxtyping_like")


def test_no_import_statement_names_jax_or_the_jax_package():
    offenders = []
    for path in _port_files():
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            elif (isinstance(node, ast.Call) and isinstance(node.func, (ast.Name, ast.Attribute))
                  and getattr(node.func, "id", getattr(node.func, "attr", "")) in
                  ("import_module", "__import__") and node.args
                  and isinstance(node.args[0], ast.Constant)):
                names = [str(node.args[0].value)]
            else:
                continue
            offenders += [(os.path.relpath(path, REPO), n) for n in names if _is_forbidden(n)]
    assert len(_port_files()) > 20
    assert offenders == []


def test_no_port_file_imports_scikit_learn():
    """The GPU machine has no scikit-learn: the DisCo labels use the port's k-means."""
    offenders = []
    for path in _port_files():
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [(os.path.relpath(path, REPO), n) for n in names
                          if n == "sklearn" or n.startswith("sklearn.")]
    assert offenders == []


def test_no_port_file_imports_cv2_or_pillow():
    """The GPU machine has neither: drawing, JPEG and AVI are the port's own."""
    offenders = []
    for path in _port_files():
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [(os.path.relpath(path, REPO), n) for n in names
                          if n.split(".")[0] in ("cv2", "PIL")]
    assert offenders == []


def test_importing_every_port_module_loads_no_jax():
    code = """
import importlib, pkgutil, sys
import pantomatrix_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
loaded = [m for m in sys.modules
          if m in ("jax", "jaxlib", "pantomatrix_tpu", "cv2", "PIL")
          or m.startswith(("jax.", "jaxlib.", "pantomatrix_tpu.", "cv2.", "PIL."))]
print(len(names), "modules")
for want in ("ops.vq_cuda", "ops.lstm_cuda", "nn.lstm", "models.camn", "models.disco",
             "cli.test_emage", "cli.test_camn", "cli.test_disco", "models.emage_graph",
             "serve", "serve_http", "cli.serve", "cli.bench_stream", "entry",
             "utils.device", "core.smplx", "core.motion_rep", "data.preprocess",
             "eval.dsp", "eval.metrics", "eval.mertic", "eval.fgd_encoder", "eval.pipeline",
             "eval.test_flow", "cli.evaluate", "train.losses", "train.optim", "train.steps",
             "train.ckpt", "train.loop", "train.logging", "utils.config", "data.beat2",
             "data.device_data", "cli._train_common", "cli.train_camn", "cli.train_disco",
             "cli.train_emage", "cli.train_emage_vq", "cli.preprocess", "cli.bench_train",
             "native", "native.mp3", "viz.avi", "viz.draw", "viz.jpeg", "viz.mesh_video",
             "viz.render2d", "utils.registry"):
    assert "pantomatrix_tpu_torch." + want in names, names
assert not loaded, loaded
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "modules" in r.stdout
