"""The port's copy of the expert-offload simulator (``core/simulator.py``,
the CGOPipe pipeline model behind the paper's Fig 5/6, numpy only) against
the JAX package's on the same configurations and seeds: every ``SimResult``
field equal, analytic and on the event timeline, peer and host, and the
expert access model's samples identical.  Its tokens/s are the cost
model's (simulated), not a measurement."""
import dataclasses

import numpy as np
import pytest

from repro.configs import get_config
from repro.core import simulator as jsim
from repro.core.runtime import HarvestRuntime
from repro.core.tiers import H100_NVLINK
from repro_torch import core as tcore
from repro_torch.configs import get_config as t_get_config

ARCHS = ["llama4-maverick-400b-a17b", "qwen2-moe", "phi-3.5-moe"]


@pytest.mark.parametrize("use_timeline", [False, True])
@pytest.mark.parametrize("use_peer", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_simulate_moe_decode_matches_jax(arch, use_peer, use_timeline):
    """Half the experts offloaded, two decode steps, one seed; a runtime of
    each package's own for the timeline (its TransferEngine and
    metrics)."""
    results = []
    for get, sim, runtime in (
            (get_config, jsim, lambda: HarvestRuntime(hardware=H100_NVLINK)),
            (t_get_config, tcore, lambda: tcore.HarvestRuntime(
                hardware=tcore.H100_NVLINK))):
        hw = H100_NVLINK if sim is jsim else tcore.H100_NVLINK
        results.append(sim.simulate_moe_decode(
            get(arch), hw, 0.5, use_peer=use_peer, decode_steps=2,
            access=sim.AccessModelConfig(seed=3),
            runtime=runtime() if use_timeline else None,
            use_timeline=use_timeline))
    jres, tres = results
    assert dataclasses.asdict(tres) == dataclasses.asdict(jres)
    assert tres.tokens_per_s > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_expert_access_model_samples_match_jax(arch):
    """Zipf-skewed drifting samples, across a drift (every 4 micro-batches
    here), equal draw for draw."""
    mc = get_config(arch).moe
    cfg = dict(zipf_alpha=0.9, drift_every=4, seed=7)
    j = jsim.ExpertAccessModel(mc.num_experts, mc.top_k,
                               jsim.AccessModelConfig(**cfg))
    t = tcore.ExpertAccessModel(mc.num_experts, mc.top_k,
                                tcore.AccessModelConfig(**cfg))
    for _ in range(10):
        np.testing.assert_array_equal(t.sample_microbatch(33),
                                      j.sample_microbatch(33))
