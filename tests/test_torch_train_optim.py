"""The port's training losses (pantomatrix_tpu_torch/train/losses.py) against the JAX
package's, and its optimizer and schedules (train/optim.py) against optax, on the CPU.

Tolerances: losses within 1e-6 (float32, summed in other orders); learning rates within
1e-6 of the peak rate (the port computes the schedule in float64, optax in float32, whose
cosine is off by a few 1e-7 of the peak where the rate nears zero); 5 updates
from the same given gradients within 1e-6 of optax. Adam is held on given gradients, not
through a model: its early steps are about sign(g) * lr, which would turn the last-ulp
differences between two programs' gradients into visible ones.
"""
import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from pantomatrix_tpu.train import losses as jlosses
from pantomatrix_tpu.train.optim import make_optimizer as jmake_optimizer
from pantomatrix_tpu.train.optim import make_schedule as jmake_schedule
from pantomatrix_tpu_torch.train import losses
from pantomatrix_tpu_torch.train.optim import lr_factor, make_optimizer

torch.set_num_threads(2)
RNG = np.random.RandomState(0)
PARTS = ("upper", "lower", "hands", "face")


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _rotations(n):
    """Random rotation matrices (n, 3, 3) from random quaternions."""
    q = RNG.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    return np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
        2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
        2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        axis=1).reshape(n, 3, 3).astype(np.float32)


def _loss_cases():
    a = RNG.normal(size=(3, 5, 7)).astype(np.float32)
    b = RNG.normal(size=(3, 5, 7)).astype(np.float32)
    pred = {f"{k}_{p}": RNG.normal(size=(2, 6, 16)).astype(np.float32)
            for k in ("rec", "cls") for p in PARTS}
    lat = {p: RNG.normal(size=(2, 6, 16)).astype(np.float32) for p in PARTS}
    idx = {p: RNG.randint(0, 16, (2, 6)).astype(np.int64) for p in PARTS}
    w = dict(lu=3.0, ll=3.0, lh=3.0, lf=3.0)
    c = dict(cu=1.0, cl=1.0, ch=1.0, cf=0.0)
    m1, m2 = _rotations(40), _rotations(40)
    m1[:5] = m2[:5]  # identical rotations: the clamp near cos = 1
    feats = RNG.normal(size=(6, 9, 8)).astype(np.float32)
    labels = np.asarray([[0], [1], [0], [2], [1], [0]], np.int64)
    return {
        "mse": ((a, b), {}),
        "rec_loss": ((pred, lat), w),
        "nll_loss": ((np.log(np.full((2, 6, 16), 1 / 16, np.float32)) + pred["cls_upper"] * 0.1,
                      idx["upper"]), {}),
        "cls_loss": ((pred, idx), c),
        "geodesic_loss": ((m1, m2), {}),
        "contrastive_loss": ((feats / np.linalg.norm(feats, axis=1, keepdims=True), labels), {}),
        "huber_loss": ((a * 2, b), {}),
    }


@pytest.mark.parametrize("name", list(_loss_cases()))
def test_loss_matches_jax(name):
    args, kw = _loss_cases()[name]
    conv = lambda f, x: {k: f(v) for k, v in x.items()} if isinstance(x, dict) else f(x)
    want = getattr(jlosses, name)(*[conv(jnp.asarray, a) for a in args], **kw)
    got = getattr(losses, name)(*[conv(_t, a) for a in args], **kw)
    np.testing.assert_allclose(float(got), float(want), rtol=0, atol=1e-6)


SCHEDULES = [("constant", 0, 40), ("constant_with_warmup", 10, 40), ("linear", 0, 40),
             ("cosine", 10, 40), ("cosine", 0, 30)]


@pytest.mark.parametrize("name,warmup,total", SCHEDULES)
def test_schedule_matches_optax_for_50_steps(name, warmup, total):
    """The learning rate of every one of 50 updates: the port's schedule function, and
    the rate the optimizer actually runs each update at (LambdaLR stepped after each)."""
    lr = 3e-4
    want = jmake_schedule(name, lr, warmup, total)
    want = [float(want(k)) if callable(want) else want for k in range(50)]
    got = [lr * lr_factor(name, warmup, total)(k) for k in range(50)]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * lr)
    p = torch.nn.Parameter(torch.zeros(3))
    opt = make_optimizer([p], learning_rate=lr, lr_scheduler=name, warmup_steps=warmup,
                         total_steps=total, optimizer="sgd")
    used = []
    for _ in range(50):
        used.append(opt.lr)
        p.grad = torch.zeros(3)
        opt.step()
    np.testing.assert_allclose(used, want, rtol=0, atol=1e-6 * lr)


@pytest.mark.parametrize("kind,kw", [
    ("adam", dict(learning_rate=1e-2)),
    ("adamw", dict(learning_rate=1e-2, weight_decay=0.1)),
    ("sgd", dict(learning_rate=0.1, optimizer="sgd")),
    ("sgd_decay", dict(learning_rate=0.1, optimizer="sgd", weight_decay=0.05)),
    ("adam_cosine", dict(learning_rate=1e-2, lr_scheduler="cosine", warmup_steps=2,
                         total_steps=8)),
])
def test_optimizer_matches_optax_on_given_gradients(kind, kw):
    shapes = [(5, 4), (7,)]
    params0 = [RNG.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[RNG.normal(size=s).astype(np.float32) for s in shapes] for _ in range(5)]

    tx = jmake_optimizer(**kw)
    jp = [jnp.asarray(p) for p in params0]
    state = tx.init(jp)
    for g in grads:
        upd, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, upd)

    tp = [torch.nn.Parameter(_t(p).clone()) for p in params0]
    opt = make_optimizer(tp, **kw)
    for g in grads:
        opt.zero_grad()
        for p, x in zip(tp, g):
            p.grad = _t(x).clone()
        opt.step()
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=0, atol=1e-6)


@pytest.mark.parametrize("parity", ["reference", "fixed"])
def test_clip_parity(parity):
    """"reference" does not clip (the reference clips before backward); "fixed" clips the
    global norm, as optax.clip_by_global_norm does."""
    g = [np.full((4,), 3.0, np.float32), np.full((3,), -4.0, np.float32)]  # norm ~9.6
    kw = dict(learning_rate=0.1, optimizer="sgd", max_grad_norm=1.0, clip_parity=parity)
    tx = jmake_optimizer(**kw)
    zeros = [jnp.zeros(x.shape) for x in g]
    upd, _ = tx.update([jnp.asarray(x) for x in g], tx.init(zeros), zeros)
    tp = [torch.nn.Parameter(torch.zeros(x.shape)) for x in g]
    opt = make_optimizer(tp, **kw)
    for p, x in zip(tp, g):
        p.grad = _t(x).clone()
    opt.step()
    for a, b in zip(tp, upd):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-5, atol=1e-7)
    norm = np.sqrt(sum(float((a.detach() ** 2).sum()) for a in tp)) / 0.1
    assert (norm < 1.0 + 1e-5) if parity == "fixed" else norm > 9.0
    with pytest.raises(ValueError):
        make_optimizer(tp, clip_parity="sometimes")
