"""The port's train step against the JAX engine, on the CPU.

Reduced qwen-1.5b, LongAlign lengths planned by LB-Mini, world 2 and 4
(the JAX side on the fake host devices of ``tests/conftest.py``, the port
with every rank on the CPU).  JAX weights and AdamW state cross over
through ``repro_torch.bridge``; the batches come from each package's own
``build_minibatch`` (held equal in ``tests/test_torch_data.py``).

* Step-0 gradients of all six comm x schedule pairs against ``jax.grad``
  of the summed ``T.loss`` over every rank's microbatches divided by the
  global token count, leaf by leaf.  Tolerance: |diff| <= 1e-4 *
  max|ref| over the leaf: the gradient is a sum over tokens, microbatches
  and ranks that XLA and PyTorch take in different orders (f32 rounding,
  about 1e-6 of the leaf's scale), while a wrong gradient (a rank, a layer
  or the normalization missing) is off by O(1) of it.
* Three-step losses against ``gspmd.make_train_step`` for collective x
  layer and ODC x minibatch.  Tolerance: 1e-5 relative.  The forward
  matches to f32 rounding, and AdamW's first steps move each weight by
  about lr * sign(g), so a gradient element whose sign flips under
  another summation order moves by up to 2 * lr (lr = 1e-3), which
  changes the loss by far less than 1e-5 of itself.
* ODC against collective in the port: equal step-0 losses (the same
  forward, tolerance 0), later losses within the same 1e-5.
* The train driver's CLI on ``--device cpu --reduced``.
"""
import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.gspmd import GSPMDConfig, make_train_step
from repro.data.loader import SyntheticSFTLoader as JLoader
from repro.data.packing import build_minibatch as jbuild
from repro.launch.mesh import make_host_mesh
from repro.models import transformer as JT
from repro.optim import AdamWConfig as JAdamW
from repro.optim import adamw_init as jinit
from repro_torch import bridge
from repro_torch.configs import get_reduced
from repro_torch.core import fsdp
from repro_torch.core.ranks import RankGroup
from repro_torch.core.train_step import Trainer
from repro_torch.data.loader import SyntheticSFTLoader
from repro_torch.data.packing import build_minibatch
from repro_torch.launch import train as train_cli
from repro_torch.optim.adamw import AdamWConfig

ARCH = "qwen-1.5b"
GRAD_TOL = 1e-4
LOSS_RTOL = 1e-5
LR = 1e-3
MAX_TOKENS = 128
PAIRS = [("collective", "layer"), ("odc", "minibatch"),
         ("odc", "layer"), ("collective", "minibatch"),
         ("odc-overlap", "overlap"), ("collective", "overlap")]


def _loader(cls, world):
    return cls("longalign", vocab_size=512, world_size=world,
               minibatch_per_device=2, max_tokens=MAX_TOKENS, max_len=120,
               seed=0)


@pytest.fixture(scope="module")
def jax_model():
    cfg = jconfigs.get_reduced(ARCH)
    params = JT.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, params


def _trainer(world, comm, schedule):
    return Trainer(get_reduced(ARCH), RankGroup.make(world, "cpu"),
                   comm=comm, schedule=schedule,
                   opt_cfg=AdamWConfig(lr=LR))


def _state(jax_model, trainer):
    _, params = jax_model
    np_params = jax.tree.map(np.asarray, params)
    return bridge.train_state_from_numpy(
        np_params, jax.tree.map(np.asarray, jinit(params)), trainer)


def _steps(world, n):
    """n steps of (JAX batch, port batch, per-rank microbatch counts)."""
    out = []
    for a, b in zip(_loader(JLoader, world).steps(n),
                    _loader(SyntheticSFTLoader, world).steps(n)):
        out.append((jbuild(a["plan"], a["sample_tokens"], MAX_TOKENS),
                    build_minibatch(b["plan"], b["sample_tokens"],
                                    MAX_TOKENS),
                    [len(d) for d in b["plan"].assignments]))
    return out


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.fixture(scope="module", params=[2, 4])
def step0(request, jax_model):
    """world, the step-0 batch, and jax.grad of the global mean loss."""
    world = request.param
    cfg, params = jax_model
    jb, tb, counts = _steps(world, 1)[0]
    M = jb["tokens"].shape[0]

    def total(p):
        lsum, tok = 0.0, 0.0
        for r in range(world):
            for j in range(M):
                mb = {k: v[j, r:r + 1] for k, v in jb.items()}
                l, m = JT.loss(cfg, p, mb, reduction="sum")
                lsum, tok = lsum + l, tok + m["tokens"]
        return lsum / jnp.maximum(tok, 1.0), tok

    (loss, tok), grads = jax.value_and_grad(total, has_aux=True)(params)
    return world, tb, counts, float(loss), float(tok), grads


@pytest.mark.parametrize("comm,schedule", PAIRS)
def test_step0_gradients_match_jax_grad(step0, jax_model, comm, schedule):
    world, tb, counts, loss, tok, ref = step0
    tr = _trainer(world, comm, schedule)
    shards, _ = _state(jax_model, tr)
    grads, metrics = tr.grads(shards, tb, counts)
    assert float(metrics["tokens"]) == tok
    assert abs(float(metrics["loss"]) - loss) <= 1e-6 * abs(loss)
    full = tr.unshard(grads)
    for path, g in jax.tree_util.tree_leaves_with_path(ref):
        keys = tuple(k.key for k in path)
        g = np.asarray(g)
        ours = _get(full, keys).numpy()
        assert ours.shape == g.shape
        err = np.abs(ours - g).max()
        assert err <= GRAD_TOL * np.abs(g).max(), (keys, float(err))


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("comm,schedule", PAIRS[:2])
def test_three_step_losses_match_the_jax_engine(jax_model, world, comm,
                                                schedule):
    cfg, params = jax_model
    mesh = make_host_mesh(data=world, model=1)
    step = jax.jit(make_train_step(
        cfg, mesh, GSPMDConfig(comm=comm, schedule=schedule,
                               block_kv=MAX_TOKENS), JAdamW(lr=LR)))
    tr = _trainer(world, comm, schedule)
    shards, opt = _state(jax_model, tr)
    jp, jo = params, jinit(params)
    for jb, tb, counts in _steps(world, 3):
        with mesh:
            jp, jo, jm = step(jp, jo, jb)
        shards, opt, tm = tr.step(shards, opt, tb, counts)
        ref = float(jm["loss"])
        assert abs(float(tm["loss"]) - ref) <= LOSS_RTOL * abs(ref)
        assert float(tm["tokens"]) == float(jm["tokens"])
    assert int(opt[0]["step"]) == 3


@pytest.mark.parametrize("world", [2, 4])
def test_odc_against_collective(jax_model, world):
    losses = {}
    for comm, schedule in PAIRS:
        tr = _trainer(world, comm, schedule)
        shards, opt = _state(jax_model, tr)
        losses[comm, schedule] = []
        for _, tb, counts in _steps(world, 3):
            shards, opt, m = tr.step(shards, opt, tb, counts)
            losses[comm, schedule].append(float(m["loss"]))
    ref = losses["collective", "layer"]
    for key, ls in losses.items():
        assert ls[0] == ref[0], key
        for a, b in zip(ls[1:], ref[1:]):
            assert abs(a - b) <= LOSS_RTOL * abs(b), key


@pytest.mark.parametrize("comm,schedule", PAIRS)
def test_step_reports_the_gradient_norm_before_clipping(jax_model, comm,
                                                        schedule):
    """``metrics["grad_norm"]`` is the global norm of the whole step-0
    gradient, each sharded leaf counted once.  Tolerance 1e-5 relative:
    an f32 sum of squares over every element in another order than the
    float64 reference."""
    _, tb, counts = _steps(2, 1)[0]
    tr = _trainer(2, comm, schedule)
    shards, opt = _state(jax_model, tr)
    grads, _ = tr.grads(shards, tb, counts)
    full = tr.unshard(grads)
    ref = sum(float(fsdp.get(full, p).double().square().sum())
              for p in fsdp.tree_paths(full)) ** 0.5
    _, _, m = tr.step(shards, opt, tb, counts)
    assert abs(float(m["grad_norm"]) - ref) <= 1e-5 * ref


def test_data_axis_zero_keeps_ranks_on_one_card(monkeypatch):
    """n = 0 is one rank per visible device: one rank on one card, and a
    refusal on several, since ranks on separate cards are not ported
    (every CUDA rank lies on the current card)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert RankGroup.make(0, "cuda").devices == (torch.device("cuda", 0),)
    assert RankGroup.make(2, "cuda").n == 2
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    with pytest.raises(NotImplementedError, match="separate cards"):
        RankGroup.make(0, "cuda")
    assert RankGroup.make(0, "cpu").n == 1


def test_shards_follow_the_jax_layout():
    """Each leaf is split on the data dim of ``gspmd.leaf_pspec`` and
    unsharding gives the tree back."""
    tr = _trainer(2, "odc", "minibatch")
    dims = tr.dims
    assert _get(dims, ("embed",)) == 1
    assert _get(dims, ("final_norm",)) == 0
    for name, d in (("wq", 1), ("wk", 1), ("wv", 1), ("wo", 2)):
        assert _get(dims, ("layers", "attn", name)) == d
    for name, d in (("w_gate", 1), ("w_up", 1), ("w_down", 2)):
        assert _get(dims, ("layers", "mlp", name)) == d
    assert _get(dims, ("layers", "attn_norm")) == 1
    assert fsdp.leaf_dim(("final_norm",), (5,), 2) is None  # replicated
    params = {"embed": torch.arange(24.0).reshape(4, 6),
              "final_norm": torch.arange(6.0)}
    shards = fsdp.shard_params(params, RankGroup.make(2, "cpu"))
    assert shards[1]["embed"].shape == (4, 3)
    back = fsdp.unshard_params(shards, fsdp.leaf_dims(params, 2))
    assert all(torch.equal(back[k], params[k]) for k in params)


def test_driver_cli_on_cpu(capsys):
    assert train_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                           "--data-axis", "2", "--steps", "2",
                           "--comm", "collective", "--schedule",
                           "layer"]) == 0
    out = capsys.readouterr().out
    assert "step    0 loss=" in out and "step    1 loss=" in out
    assert "done: " in out and "tok/s" in out and "kernel launches" in out
    summary = train_cli.run(train_cli.parse_args(
        ["--arch", ARCH, "--reduced", "--device", "cpu", "--data-axis", "2",
         "--steps", "2", "--cosine", "--warmup-steps", "1"]))
    assert len(summary["losses"]) == 2
    assert all(np.isfinite(summary["losses"]))
    assert all(np.isfinite(st["grad_norm"]) for st in summary["steps"])
    assert summary["world"] == 2
    # CPU tensors take the plain versions: no kernel launched
    assert set(summary["launches"].values()) == {0}


@pytest.mark.parametrize("flags", [
    ["--trace", "t.json"], ["--metrics", "m.jsonl"], ["--schedule", "1f1b"],
    ["--comm", "pipe"], ["--comm", "hier"], ["--comm", "pipe-int8"],
    ["--pipe-stages", "2"], ["--model-axis", "2"],
    ["--comm", "cp", "--schedule", "overlap"]])
def test_driver_refuses_what_is_not_ported(flags, capsys):
    with pytest.raises(SystemExit):
        train_cli.parse_args(["--reduced", "--device", "cpu", *flags])
    assert "not yet ported" in capsys.readouterr().err


def test_driver_needs_a_card_unless_told_cpu():
    args = train_cli.parse_args(["--reduced", "--steps", "1"])
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_cli.run(args)


@pytest.mark.parametrize("world", [2, 4])
def test_profile_ordered_rings_keep_the_step(jax_model, world):
    """A DeviceProfile reorders the ODC rings, not the result: the same
    loss, and gradients within the summation-order tolerance above."""
    from repro_torch.balance.cost import make_straggler_profile

    _, tb, counts = _steps(world, 1)[0]
    out = {}
    for prof in (None, make_straggler_profile("uniform", world, seed=0)):
        tr = Trainer(get_reduced(ARCH), RankGroup.make(world, "cpu"),
                     comm="odc", schedule="minibatch", device_profile=prof)
        assert (tr.order is None) == (prof is None)
        shards, _ = _state(jax_model, tr)
        grads, m = tr.grads(shards, tb, counts)
        out[prof is None] = (float(m["loss"]), tr.unshard(grads))
    (la, ga), (lb, gb) = out[True], out[False]
    assert la == lb
    for path in fsdp.tree_paths(ga):
        a, b = fsdp.get(ga, path), fsdp.get(gb, path)
        assert (a - b).abs().max() <= GRAD_TOL * b.abs().max()


@pytest.mark.parametrize("arch", ["qwen-1.5b", "gemma2-9b"])
@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("reduction", ["sum", "mean"])
def test_loss_and_gradients_match(arch, remat, reduction):
    """``transformer.loss`` and its gradients against the JAX ``T.loss``
    on one packed microbatch (gemma2: sliding window on alternate layers,
    attention and final soft-capping).  Same leaf-scaled tolerance as the
    train-step gradients; the loss within 1e-6 relative."""
    from repro_torch.models import transformer as TT

    cfg = jconfigs.get_reduced(arch)
    params = JT.init_params(cfg, jax.random.PRNGKey(1))
    jb, tb, _ = _steps(2, 1)[0]
    mb = {k: v[0, 0:1] for k, v in jb.items()}
    (ref, jm), jg = jax.value_and_grad(
        lambda p: JT.loss(cfg, p, mb, remat=remat, reduction=reduction),
        has_aux=True)(params)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    for path in fsdp.tree_paths(tp):
        fsdp.get(tp, path).requires_grad_(True)
    tmb = {k: torch.from_numpy(np.ascontiguousarray(v[0, 0:1]))
           for k, v in tb.items()}
    ours, tm = TT.loss(get_reduced(arch), tp, tmb, remat=remat,
                       reduction=reduction)
    ours.backward()
    assert float(tm["tokens"]) == float(jm["tokens"])
    assert abs(ours.item() - float(ref)) <= 1e-6 * abs(float(ref))
    for path, g in jax.tree_util.tree_leaves_with_path(jg):
        keys = tuple(k.key for k in path)
        g = np.asarray(g)
        err = np.abs(fsdp.get(tp, keys).grad.numpy() - g).max()
        assert err <= GRAD_TOL * np.abs(g).max(), (arch, keys, float(err))
