"""What the train tests of the port share: the reduced qwen-1.5b case,
its loaders and batches (each package's own ``build_minibatch``, held
equal in ``tests/test_torch_data.py``), the JAX weights and AdamW state
bridged into a port ``Trainer``, and one torch thread per test (the
suite runs several workers on the CPU's cores, and these small tensors
gain nothing from more)."""
import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data.loader import SyntheticSFTLoader as JLoader
from repro.data.packing import build_minibatch as jbuild
from repro.models import transformer as JT
from repro.optim import adamw_init as jinit
from repro_torch import bridge
from repro_torch.configs import get_reduced
from repro_torch.core.ranks import RankGroup
from repro_torch.core.train_step import Trainer
from repro_torch.data.loader import SyntheticSFTLoader
from repro_torch.data.packing import build_minibatch
from repro_torch.optim.adamw import AdamWConfig

ARCH = "qwen-1.5b"
#: layers of a parity case whose reduced config's 2 would not hold its
#: whole attention pattern (gemma3: five local layers, then a global one)
CASE_LAYERS = {"gemma3-27b": 6}
GRAD_TOL = 1e-4
LOSS_RTOL = 1e-5
LR = 1e-3
MAX_TOKENS = 128
PAIRS = [("collective", "layer"), ("odc", "minibatch"),
         ("odc", "layer"), ("collective", "minibatch"),
         ("odc-overlap", "overlap"), ("collective", "overlap")]


@pytest.fixture(autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


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


def global_mean_grad(cfg, params, jb, world):
    """(loss, tokens, grads): ``jax.value_and_grad`` of the summed
    ``T.loss`` over every rank's microbatches of the JAX batch ``jb``,
    divided by the global token count: the gradient every engine's step
    computes, taken without any engine."""
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
    return float(loss), float(tok), grads


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def reduced_case(arch):
    """(JAX config, port config) of a parity case: each package's reduced
    ``arch``, at CASE_LAYERS' depth where it names one."""
    from repro.models.config import reduced as jreduced
    from repro_torch.configs import get_config
    from repro_torch.models.config import reduced

    n = CASE_LAYERS.get(arch, 2)
    return (jreduced(jconfigs.get_config(arch), num_layers=n),
            reduced(get_config(arch), num_layers=n))
