"""The 1F1B pipeline issue order, a verbatim copy of
``repro.sim.timeline.stage_partition`` and ``instructions_1f1b`` (the
copy rule: the port imports nothing of the JAX package;
``tests/test_torch_pipe.py`` holds the copy to the original).

``instructions_1f1b`` is the one definition of the order in which the
``'1f1b'`` schedule (``repro_torch.core.backend.build_schedule_grad``)
issues each rank's microbatch forwards and backwards.
"""
from __future__ import annotations

from typing import List, Tuple


def stage_partition(num_layers: int, stages: int) -> List[int]:
    """Contiguous per-stage layer counts: ``num_layers`` split into
    ``stages`` chunks with the remainder going to the earliest stages (the
    standard pipeline partition).  Stages beyond the layer count get zero
    layers — they still relay activations, they just do no compute."""
    if stages <= 0:
        raise ValueError(f"stages must be positive, got {stages}")
    if num_layers < 0:
        raise ValueError(f"num_layers must be >= 0, got {num_layers}")
    base, rem = divmod(num_layers, stages)
    return [base + (1 if s < rem else 0) for s in range(stages)]


def instructions_1f1b(num_microbatches: int, stages: int, *, stage: int = 0,
                      interleave: bool = False) -> List[Tuple[str, int]]:
    """The 1F1B issue order at one pipeline stage: ``[("F", j) | ("B", j)]``.

    Stage ``s`` of ``S`` runs ``S - 1 - s`` warmup forwards (filling the
    pipeline), then strict one-forward-one-backward alternation (bounding
    in-flight activations at the warmup depth + 1), then drains the
    remaining backwards.  ``interleave=True`` halves the warmup depth —
    the reduced-residency interleaved variant, where each stage holds two
    half-size virtual stages so its fill obligation is split.

    This function is the ONE definition of the issue order: the sim's
    :class:`PipelineStagePolicy` schedules per-stage lanes from it and the
    executable ``schedule='1f1b'`` gradient loop
    (``repro.core.backend.build_schedule_grad``) issues its microbatch
    forward/backward calls from the same list, so executable and simulated
    pipelines share their schedule shape by construction.
    """
    M, S = num_microbatches, stages
    if S <= 0:
        raise ValueError(f"stages must be positive, got {S}")
    if not 0 <= stage < S:
        raise ValueError(f"stage {stage} out of range for {S} stages")
    if M < 0:
        raise ValueError(f"num_microbatches must be >= 0, got {M}")
    w = S - 1 - stage
    if interleave:
        w = (w + 1) // 2
    w = min(w, M)
    out: List[Tuple[str, int]] = [("F", j) for j in range(w)]
    for j in range(M - w):
        out.append(("F", w + j))
        out.append(("B", j))
    out.extend(("B", j) for j in range(M - w, M))
    return out
