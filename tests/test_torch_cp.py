"""The port's context parallelism against the JAX package, on the CPU.

* Layout: ``interleave_indices``, ``unshuffle_indices``,
  ``_unshuffle_gathered`` and ``_reshuffle_global`` equal the JAX
  package's exactly, and the last two are inverses.
* The state sweep: ``flash_attention_state_plain`` over 2-3 kv chunks
  against the JAX ``flash_attention_state(..., interpret=True)``, the
  carry after each chunk and the ``finish_attention`` output, on rows with
  at least one valid key so far.  Tolerance |diff| <= 1e-5 * (1 + |ref|):
  float32 both sides, dot products and chunk sums in another order (about
  1e-7 of the values; a wrong mask, carry or rescale is off by O(1)).
* Ring attention (cp 2 and 4, interleave on and off, window 0 and 96,
  packed segments with a padding tail, GQA 4/2) and its plain version
  ``allgather_attention``, forward and dq/dk/dv, against the JAX
  ``flash_attention_diff`` on the gathered sequence (not against the JAX
  ring, whose bitwise golden test fails on this tree).  Tolerance as
  above, over rows with a valid key: the forward and dq on those rows,
  and dk and dv of a cotangent that is 0 on the others.
* ``lb_token`` plans and ``build_minibatch``'s cp rows equal the JAX
  package's exactly.
* ``Trainer(comm='cp')`` on reduced qwen against ``gspmd.make_train_step``
  on ``make_cp_mesh(cp=2, data=d)`` (lb_token plans, minibatch and layer
  schedules): three steps, losses within 1e-5 relative (the reason is in
  ``tests/test_torch_train.py``), tokens equal; the same for reduced
  chameleon-34b (the vlm family, qk-norm) at data 1, minibatch; and
  against the port's flat ODC on the same global batch.
* Save then resume under cp is bitwise; the train CLI runs cp on the CPU and
  refuses cp under the overlap schedule.
"""
import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from repro import configs as jconfigs
from repro.balance.strategies import lb_token as jlb_token
from repro.core import cp as jcp
from repro.core.gspmd import GSPMDConfig, ShardingRules, make_train_step
from repro.data.loader import SyntheticSFTLoader as JLoader
from repro.data.packing import build_minibatch as jbuild
from repro.kernels import flash_attention as jfa
from repro.launch.mesh import make_cp_mesh
from repro.models import transformer as JT
from repro.optim import AdamWConfig as JAdamW
from repro.optim import adamw_init as jinit
from repro_torch import bridge
from repro_torch.balance.strategies import lb_token
from repro_torch.configs import get_reduced
from repro_torch.core import backend as B
from repro_torch.core import cp, fsdp
from repro_torch.core.ranks import RankGroup, cp_groups
from repro_torch.core.train_step import Trainer
from repro_torch.data.loader import SyntheticSFTLoader
from repro_torch.data.packing import build_minibatch
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import train as train_cli
from repro_torch.optim.adamw import AdamWConfig

ARCH = "qwen-1.5b"
TOL = 1e-5
LOSS_RTOL = 1e-5
LR = 1e-3
MAX_TOKENS = 128


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread per test: the suite runs several workers on the
    CPU's cores, and these small tensors gain nothing from more."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _close(got, want, rows=None):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if rows is not None:
        got, want = got[rows], want[rows]
    err = np.abs(got - want)
    assert np.isfinite(got).all()
    assert (err <= TOL * (1 + np.abs(want))).all(), float(err.max())


# ===========================================================================
# layout
# ===========================================================================
@pytest.mark.parametrize("total,n", [(8, 2), (64, 4), (96, 3)])
def test_layout_helpers_equal_jax(total, n):
    perm = cp.interleave_indices(total, n)
    inv = cp.unshuffle_indices(total, n)
    np.testing.assert_array_equal(perm, jcp.interleave_indices(total, n))
    np.testing.assert_array_equal(inv, jcp.unshuffle_indices(total, n))
    np.testing.assert_array_equal(perm[inv], np.arange(total))
    x = np.random.default_rng(0).normal(size=(total, 3, 2)).astype(
        np.float32)
    g = cp._unshuffle_gathered(torch.from_numpy(x), n)
    np.testing.assert_array_equal(
        g.numpy(), np.asarray(jcp._unshuffle_gathered(jnp.asarray(x), n)))
    np.testing.assert_array_equal(g.numpy(), x[inv])
    back = cp._reshuffle_global(g, n)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jcp._reshuffle_global(g.numpy(), n)))
    np.testing.assert_array_equal(back.numpy(), x)


def test_cp_groups_are_adjacent_ranks():
    assert cp_groups(4, 2) == [range(0, 2), range(2, 4)]
    assert cp_groups(3, 1) == [range(0, 1), range(1, 2), range(2, 3)]
    with pytest.raises(ValueError, match="groups"):
        cp_groups(3, 2)
    with pytest.raises(ValueError, match="multiple"):
        cp.interleave_indices(6, 2)


# ===========================================================================
# the state sweep
# ===========================================================================
def _packed(B_=2, S=256, H=4, KH=2, hd=32, seed=0):
    """Packed multi-segment global arrays with a padding tail, as the JAX
    package's cp tests build them; and a cotangent."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B_, S, H, hd)).astype(np.float32)
    k = rng.normal(size=(B_, S, KH, hd)).astype(np.float32)
    v = rng.normal(size=(B_, S, KH, hd)).astype(np.float32)
    g = rng.normal(size=(B_, S, H, hd)).astype(np.float32)
    pos = np.zeros((B_, S), np.int32)
    seg = np.full((B_, S), -1, np.int32)
    for b in range(B_):
        bounds = [0, S // 3, S // 3 + S // 4, S - S // 8, S]
        for s, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
            if s == len(bounds) - 2:
                pos[b, lo:hi] = -(10 ** 9)  # padding tail
            else:
                pos[b, lo:hi] = np.arange(hi - lo)
                seg[b, lo:hi] = s
    return q, k, v, pos, seg, g


def _valid_rows(qp, kp, qs, ks, window):
    """(B, S) rows with at least one valid key among the given keys."""
    mask = fa.attn_mask(torch.from_numpy(qp), torch.from_numpy(kp),
                        torch.from_numpy(qs), torch.from_numpy(ks),
                        causal=True, window=window)
    return mask.any(-1).numpy()


@pytest.mark.parametrize("chunks,window,softcap,H,KH", [
    (2, 0, 0.0, 4, 2), (3, 0, 0.0, 4, 4), (2, 96, 0.0, 4, 2),
    (3, 40, 30.0, 6, 2)])
def test_state_sweep_matches_jax(chunks, window, softcap, H, KH):
    """q over the gathered kv in ``chunks`` chunks, carrying the state."""
    S = 192 if chunks == 3 else 256
    q, k, v, pos, seg, _ = _packed(S=S, H=H, KH=KH)
    kw = dict(causal=True, window=window, logit_softcap=softcap)
    T = S // chunks
    jcarry, tcarry = None, None
    for c in range(chunks):
        sl = slice(c * T, (c + 1) * T)
        jcarry = jfa.flash_attention_state(
            q, k[:, sl], v[:, sl], jcarry, q_positions=pos,
            kv_positions=pos[:, sl], q_segment_ids=seg,
            kv_segment_ids=seg[:, sl], blk_q=64, blk_k=32, interpret=True,
            **kw)
        tcarry = fa.flash_attention_state_plain(
            *(torch.from_numpy(x) for x in (q, k[:, sl], v[:, sl])), tcarry,
            q_positions=torch.from_numpy(pos),
            kv_positions=torch.from_numpy(pos[:, sl]),
            q_segment_ids=torch.from_numpy(seg),
            kv_segment_ids=torch.from_numpy(seg[:, sl]), **kw)
        rows = _valid_rows(pos, pos[:, :(c + 1) * T], seg,
                           seg[:, :(c + 1) * T], window)
        for got, want in zip(tcarry, jcarry):
            _close(got.numpy(), want, rows)
    rows = _valid_rows(pos, pos, seg, seg, window)
    _close(fa.finish_attention(tcarry).numpy(),
           jfa.finish_attention(jcarry), rows)


def test_state_wrapper_updates_the_carry_in_place_on_cpu():
    q, k, v, pos, seg, _ = (torch.from_numpy(x) for x in _packed(S=64))
    kw = dict(q_positions=pos, kv_positions=pos, q_segment_ids=seg,
              kv_segment_ids=seg)
    before = fa.state_launches
    carry = fa.fresh_carry(*q.shape)
    out = fa.flash_attention_state(q, k, v, carry, **kw)
    assert all(a is b for a, b in zip(out, carry))
    for a, b in zip(carry, fa.flash_attention_state_plain(q, k, v, **kw)):
        assert torch.equal(a, b)
    assert fa.state_launches == before  # the CPU takes the plain version
    with pytest.raises(ValueError, match="carry"):
        fa.flash_attention_state(q, k, v, (carry[0][:, :1],) + carry[1:],
                                 **kw)


# ===========================================================================
# ring attention against flash_attention_diff on the gathered sequence
# ===========================================================================
def _split(x, n, perm):
    """Global (B, S, ...) numpy -> each rank's (B, S/n, ...) tensor in the
    device layout ``perm``."""
    x = torch.from_numpy(np.ascontiguousarray(x[:, perm]))
    return list(x.chunk(n, 1))


@pytest.mark.parametrize("impl", ["ring", "allgather"])
@pytest.mark.parametrize("n,interleave,window", [
    (2, True, 0), (2, False, 96), (4, True, 96), (4, False, 0)])
def test_ring_attention_matches_flash_attention_diff(impl, n, interleave,
                                                     window):
    q, k, v, pos, seg, g = _packed()
    S = q.shape[1]
    # rows without a valid key have no defined answer, and the two routes
    # differentiate them differently: their cotangent is 0 here
    rows = _valid_rows(pos, pos, seg, seg, window)
    g = g * rows[:, :, None, None]
    jpos, jseg = jnp.asarray(pos), jnp.asarray(seg)
    kw = dict(causal=True, window=window, q_positions=jpos,
              kv_positions=jpos, q_segment_ids=jseg, kv_segment_ids=jseg)
    ref, vjp = jax.vjp(lambda q, k, v: jfa.flash_attention_diff(
        q, k, v, blk_q=32, blk_k=32, interpret=True, **kw), q, k, v)
    dq_ref, dk_ref, dv_ref = vjp(jnp.asarray(g))

    perm = cp.interleave_indices(S, n) if interleave else np.arange(S)
    inv = np.argsort(perm)
    qs, ks, vs = (_split(x, n, perm) for x in (q, k, v))
    for t in qs + ks + vs:
        t.requires_grad_(True)
    fn = cp.ring_attention if impl == "ring" else cp.allgather_attention
    outs = fn(qs, ks, vs, _split(pos, n, perm), _split(seg, n, perm),
              causal=True, window=window, interleave=interleave)
    torch.autograd.backward(outs, _split(g, n, perm))

    def glob(ts):
        return torch.cat([t.detach() for t in ts], 1).numpy()[:, inv]

    _close(glob(outs), ref, rows)
    _close(glob([t.grad for t in qs]), dq_ref, rows)
    _close(glob([t.grad for t in ks]), dk_ref)
    _close(glob([t.grad for t in vs]), dv_ref)


def test_ring_attention_refuses_what_it_cannot_lay_out():
    q = torch.zeros(1, 3, 2, 32)
    p = torch.zeros(1, 3, dtype=torch.int32)
    with pytest.raises(ValueError, match="even"):
        cp.ring_attention([q, q], [q, q], [q, q], [p, p])
    with pytest.raises(ValueError, match="positions"):
        cp.ring_attention([q, q], [q, q], [q, q], [None, None],
                          interleave=False)


# ===========================================================================
# plans and batches
# ===========================================================================
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("world,cp_deg", [(2, 2), (4, 2), (8, 4)])
def test_lb_token_and_cp_rows_equal_jax(seed, world, cp_deg):
    rng = np.random.default_rng(seed)
    lens = [int(x) for x in rng.integers(16, 300, size=4 * world)] + [
        700, 512]
    MT = 512
    jp = jlb_token(lens, world, MT, cp=cp_deg)
    tp = lb_token(lens, world, MT, cp=cp_deg)
    assert tp.assignments == jp.assignments
    assert tp.cp_cells == jp.cp_cells and tp.cp_split == jp.cp_split
    toks = [rng.integers(1, 100, size=l).astype(np.int32) for l in lens]
    jb, tb = jbuild(jp, toks, MT), build_minibatch(tp, toks, MT)
    assert set(jb) == set(tb)
    for key in tb:
        np.testing.assert_array_equal(tb[key], np.asarray(jb[key]), key)
    assert tb["tokens"].shape[-1] == cp_deg * MT


# ===========================================================================
# the train step against the JAX engine
# ===========================================================================
@pytest.fixture(scope="module")
def jax_model():
    cfg = jconfigs.get_reduced(ARCH)
    return cfg, JT.init_params(cfg, jax.random.PRNGKey(0))


def _state(jax_model, trainer):
    _, params = jax_model
    return bridge.train_state_from_numpy(
        jax.tree.map(np.asarray, params),
        jax.tree.map(np.asarray, jinit(params)), trainer)


def _loader(cls, world):
    return cls("longalign", vocab_size=512, world_size=world,
               minibatch_per_device=2, max_tokens=MAX_TOKENS, max_len=250,
               seed=0, strategy="lb_token", cp=2)


@pytest.mark.parametrize("data,schedule", [
    (1, "minibatch"), (2, "minibatch"), (1, "layer"), (2, "layer")])
def test_three_step_losses_match_the_jax_cp_engine(jax_model, data,
                                                   schedule):
    cfg, params = jax_model
    world = 2 * data
    mesh = make_cp_mesh(cp=2, data=data, model=1)
    # the state stays replicated between steps, so the step compiles once
    rep = NamedSharding(mesh, P())
    step = jax.jit(make_train_step(cfg, mesh, GSPMDConfig(
        rules=ShardingRules(data=("data", "cp")), comm="cp",
        schedule=schedule, block_kv=MAX_TOKENS), JAdamW(lr=LR)),
        out_shardings=rep)
    tr = Trainer(get_reduced(ARCH), RankGroup.make(world, "cpu"), comm="cp",
                 schedule=schedule, opt_cfg=AdamWConfig(lr=LR), cp=2)
    shards, opt = _state(jax_model, tr)
    jp, jo = jax.device_put((params, jinit(params)), rep)
    split = 0
    for a, b in zip(_loader(JLoader, world).steps(3),
                    _loader(SyntheticSFTLoader, world).steps(3)):
        with mesh:
            jp, jo, jm = step(jp, jo, jbuild(a["plan"], a["sample_tokens"],
                                             MAX_TOKENS))
        batch = build_minibatch(b["plan"], b["sample_tokens"], MAX_TOKENS)
        shards, opt, tm = tr.step(shards, opt, batch,
                                  [len(x) for x in b["plan"].assignments])
        ref = float(jm["loss"])
        assert abs(float(tm["loss"]) - ref) <= LOSS_RTOL * abs(ref)
        assert float(tm["tokens"]) == float(jm["tokens"])
        split += len(b["plan"].cp_split)
    assert split > 0  # the run cut a sample across its group


def test_three_step_losses_of_chameleon_match_the_jax_cp_engine():
    """The vlm family under cp (chameleon: no vision stub, its image codes
    are tokens): reduced chameleon-34b, data 1 x cp 2, minibatch."""
    arch = "chameleon-34b"
    cfg = jconfigs.get_reduced(arch)
    params = JT.init_params(cfg, jax.random.PRNGKey(0))
    mesh = make_cp_mesh(cp=2, data=1, model=1)
    rep = NamedSharding(mesh, P())
    step = jax.jit(make_train_step(cfg, mesh, GSPMDConfig(
        rules=ShardingRules(data=("data", "cp")), comm="cp",
        schedule="minibatch", block_kv=MAX_TOKENS), JAdamW(lr=LR)),
        out_shardings=rep)
    tr = Trainer(get_reduced(arch), RankGroup.make(2, "cpu"), comm="cp",
                 schedule="minibatch", opt_cfg=AdamWConfig(lr=LR), cp=2)
    shards, opt = _state((cfg, params), tr)
    jp, jo = jax.device_put((params, jinit(params)), rep)
    for a, b in zip(_loader(JLoader, 2).steps(3),
                    _loader(SyntheticSFTLoader, 2).steps(3)):
        with mesh:
            jp, jo, jm = step(jp, jo, jbuild(a["plan"], a["sample_tokens"],
                                             MAX_TOKENS))
        batch = build_minibatch(b["plan"], b["sample_tokens"], MAX_TOKENS)
        shards, opt, tm = tr.step(shards, opt, batch,
                                  [len(x) for x in b["plan"].assignments])
        ref = float(jm["loss"])
        assert abs(float(tm["loss"]) - ref) <= LOSS_RTOL * abs(ref)
        assert float(tm["tokens"]) == float(jm["tokens"])


def test_cp_matches_flat_odc_on_the_same_batch(jax_model):
    """cp (data 2 x cp 2) against the port's flat ODC on 4 ranks: the same
    global rows, one per flat rank, or two per cp group sequence-split
    over its ranks (``tests/test_cp.py::test_cp_train_step_matches_flat_odc``
    of the JAX package).  Two rows per group is also the layout that a
    plan of another strategy than lb_token gets under cp, as in the JAX
    engine."""
    rng = np.random.default_rng(1)
    S, W = 64, 4
    tokens = rng.integers(0, 512, size=(1, W, S)).astype(np.int32)
    batch = {"tokens": tokens,
             "targets": rng.integers(0, 512, size=(1, W, S)).astype(
                 np.int32),
             "positions": np.tile(np.arange(S, dtype=np.int32), (1, W, 1)),
             "segment_ids": np.zeros((1, W, S), np.int32),
             "loss_mask": np.ones((1, W, S), np.float32)}
    perm = cp.interleave_indices(S, 2)
    cp_batch = {k: v[..., perm] for k, v in batch.items()}
    runs = {}
    for comm, b, kw in (("odc", batch, {}), ("cp", cp_batch, {"cp": 2})):
        tr = Trainer(get_reduced(ARCH), RankGroup.make(W, "cpu"), comm=comm,
                     opt_cfg=AdamWConfig(lr=LR), **kw)
        shards, opt = _state(jax_model, tr)
        runs[comm] = []
        for _ in range(3):
            shards, opt, m = tr.step(shards, opt, b, [1] * W)
            runs[comm].append((float(m["loss"]), float(m["tokens"])))
    for (lc, tc), (lo, to) in zip(runs["cp"], runs["odc"]):
        assert tc == to
        assert abs(lc - lo) <= LOSS_RTOL * abs(lo)


def test_trainer_splits_group_rows_over_the_cp_ranks():
    tr = Trainer(get_reduced(ARCH), RankGroup.make(4, "cpu"), comm="cp",
                 cp=2)
    R = 8
    batch = {"tokens": np.arange(2 * 2 * R).reshape(2, 2, R),
             "loss_mask": np.ones((2, 2, R), np.float32)}
    mbs = tr.split_batch(batch)
    assert [mbs[r][1]["tokens"].tolist() for r in range(4)] == [
        [[16, 17, 18, 19]], [[20, 21, 22, 23]], [[24, 25, 26, 27]],
        [[28, 29, 30, 31]]]
    assert tr.rank_counts([2, 1]) == [2, 2, 1, 1]
    assert tr.rank_counts([1, 2, 2, 1]) == [2, 2, 2, 2]  # 2 rows a group
    with pytest.raises(ValueError, match="comm 'cp'"):
        Trainer(get_reduced(ARCH), RankGroup.make(2, "cpu"), comm="odc",
                cp=2)
    with pytest.raises(NotImplementedError, match="overlap"):
        Trainer(get_reduced(ARCH), RankGroup.make(2, "cpu"), comm="cp",
                schedule="overlap", cp=2)
    assert B.get_backend("cp-ring") is B.get_backend("cp")


# ===========================================================================
# the train CLI
# ===========================================================================
def _args(*extra):
    return train_cli.parse_args(["--arch", ARCH, "--reduced", "--device",
                                 "cpu", "--comm", "cp", "--cp", "2",
                                 "--strategy", "lb_token", "--quiet",
                                 *extra])


def test_train_cli_trains_cp_on_cpu(capsys):
    assert train_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                           "--comm", "cp", "--cp", "2", "--strategy",
                           "lb_token", "--steps", "2"]) == 0
    out = capsys.readouterr().out
    assert "(data 1 x cp 2)" in out and "cp-split=" in out
    summary = train_cli.run(_args("--steps", "2", "--data-axis", "2"))
    assert summary["world"] == 4 and summary["cp"] == 2
    assert summary["comm"] == "cp"
    assert all(np.isfinite(summary["losses"]))
    assert sum(st["cp_split"] for st in summary["steps"]) > 0
    assert set(summary["launches"].values()) == {0}  # plain on the CPU


@pytest.mark.parametrize("flags,why", [
    (["--comm", "cp", "--schedule", "overlap"], "not yet ported"),
    (["--comm", "odc", "--cp", "2"], "--cp applies"),
    (["--comm", "cp", "--cp", "0"], "--cp must")])
def test_train_cli_refuses_cp_it_cannot_run(flags, why, capsys):
    with pytest.raises(SystemExit):
        train_cli.parse_args(["--reduced", "--device", "cpu", *flags])
    assert why in capsys.readouterr().err


def test_save_then_resume_under_cp_is_bitwise(tmp_path):
    """As ``tests/test_torch_checkpoint.py``, under cp (on one CPU thread,
    which that file's note says bitwise resumption needs)."""
    ckpt = str(tmp_path / "ckpt")
    straight = train_cli.run(_args("--steps", "3"), return_params=True)
    first = train_cli.run(_args("--steps", "2", "--ckpt-dir", ckpt,
                                "--save-every", "2"))
    resumed = train_cli.run(_args("--steps", "3", "--ckpt-dir", ckpt,
                                  "--resume"), return_params=True)
    assert first["saved"] == [2] and resumed["start_step"] == 2
    assert first["losses"] + resumed["losses"] == straight["losses"]
    a, b = straight["params"], resumed["params"]
    for path in fsdp.tree_paths(a):
        assert torch.equal(fsdp.get(a, path), fsdp.get(b, path)), path
