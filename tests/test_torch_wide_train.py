"""The port's train step at a wider d_model against the JAX engine:
chameleon-34b with one layer at d_model 2048 (16 heads of 128 with 8 KV
heads and d_ff 5504, the published config's proportions; the reduced
vocabulary of 512), 2 ranks, ODC x minibatch, three steps at the
drivers' lr 1e-3.

At its published d_model 8192 chameleon's loss rises after step 0 on the
card (PERF.md).  Here the JAX engine's loss rises after step 0 too, and
the port's three losses agree with its within LOSS_RTOL: the rise is the
reference's own AdamW step at this width, not a fault of the port.

    PYTHONPATH=src python -m pytest -q -s tests/test_torch_wide_train.py

prints both engines' losses.
One torch thread.
"""
import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax
import numpy as np
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.core.gspmd import GSPMDConfig, ShardingRules, make_train_step
from repro.launch.mesh import make_host_mesh
from repro.models import transformer as JT
from repro.models.config import reduced as jreduced
from repro.optim import AdamWConfig as JAdamW
from repro.optim import adamw_init as jinit
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core.ranks import RankGroup
from repro_torch.core.train_step import Trainer
from repro_torch.models.config import reduced
from repro_torch.optim.adamw import AdamWConfig
from torch_train_cases import LOSS_RTOL, LR, _steps, one_torch_thread  # noqa

ARCH = "chameleon-34b"
D_MODEL = 2048
WIDE = dict(num_layers=1, d_model=D_MODEL, num_heads=D_MODEL // 128,
            num_kv_heads=8, head_dim=128, d_ff=D_MODEL * 22016 // 8192)


def test_three_steps_at_d_model_2048_match_the_jax_engine():
    jcfg = jreduced(jconfigs.get_config(ARCH), **WIDE)
    cfg = reduced(get_config(ARCH), **WIDE)
    params = JT.init_params(jcfg, jax.random.PRNGKey(0))
    mesh = make_host_mesh(data=2)
    rep = NamedSharding(mesh, P())
    gcfg = GSPMDConfig(rules=ShardingRules(), comm="odc",
                       schedule="minibatch")
    step = jax.jit(make_train_step(jcfg, mesh, gcfg, JAdamW(lr=LR)),
                   out_shardings=rep)
    jp, jo = jax.device_put((params, jinit(params)), rep)
    tr = Trainer(cfg, RankGroup.make(2, "cpu"), comm="odc",
                 schedule="minibatch", opt_cfg=AdamWConfig(lr=LR))
    shards, opt = bridge.train_state_from_numpy(
        jax.tree.map(np.asarray, params),
        jax.tree.map(np.asarray, jinit(params)), tr)
    ref, ours = [], []
    for jb, tb, counts in _steps(2, 3):
        with mesh:
            jp, jo, jm = step(jp, jo, jb)
        shards, opt, m = tr.step(shards, opt, tb, counts)
        ref.append(float(jm["loss"]))
        ours.append(float(m["loss"]))
        assert float(m["tokens"]) == float(jm["tokens"])
    print(f"d_model {D_MODEL}: JAX engine losses {ref}, port {ours}")
    for a, b in zip(ours, ref):
        assert abs(a - b) <= LOSS_RTOL * abs(b), (ours, ref)
    assert ref[1] > ref[0], ref  # the reference's own rise at this width
