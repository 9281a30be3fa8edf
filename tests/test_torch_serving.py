"""The port's LM serving path (``ServingEngine``, request packing, the
``launch.serve`` driver) against the JAX package, on the CPU.

Both engines serve the same requests on the same weights (the reference's,
carried over with ``params_from_numpy``), reduced gemma-2b and gemma3-4b in
float32, greedy: the generated tokens must be equal token for token.
Sampling with a temperature draws from a ``torch.Generator``, which does
not reproduce ``jax.random``'s bits, so it is checked for determinism only.
"""
import contextlib
import io

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.reduced import reduced_config as j_reduced
from repro.core.partitioners import pack_items as j_pack_items
from repro.models import Model as JModel
from repro.models import init_params as j_init_params
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro.serving import pack_requests as j_pack_requests
from repro_torch.configs import get_config
from repro_torch.configs.reduced import reduced_config
from repro_torch.core.partitioners import pack_items
from repro_torch.launch import serve as serve_cli
from repro_torch.models import Model, params_from_numpy
from repro_torch.serving import Request, ServingEngine, pack_requests


def _engines(arch, s_max=64, temperature=0.0):
    jcfg = j_reduced(j_get_config(arch))
    cfg = reduced_config(get_config(arch))
    jp = j_init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return (ServingEngine(Model(cfg), tp, s_max=s_max, temperature=temperature),
            JServingEngine(JModel(jcfg), jp, s_max=s_max), cfg)


def _prompts(cfg, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in lens]


@pytest.mark.parametrize("arch", ["gemma-2b", "gemma3-4b"])
def test_greedy_serve_equals_reference(arch):
    """Mixed prompt lengths (past the reduced gemma3-4b's window of 8),
    several sub-batches per packed batch, unequal max_new_tokens."""
    eng, jeng, cfg = _engines(arch)
    prompts = _prompts(cfg, (4, 9, 9, 13, 6, 4), seed=1)
    news = (5, 7, 3, 6, 6, 4)
    got, stats = eng.serve([Request(i, p, n) for i, (p, n) in
                            enumerate(zip(prompts, news))], n_batches=2)
    want, jstats = jeng.serve([JRequest(i, p, n) for i, (p, n) in
                               enumerate(zip(prompts, news))], n_batches=2)
    assert sorted(got) == sorted(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
        assert got[rid].dtype == np.int32 and got[rid].shape == (news[rid],)
    assert stats["padding_efficiency"] == jstats["padding_efficiency"]
    assert stats["latency"]["n_answered"] == len(prompts)
    assert stats["latency"]["n_batches"] == jstats["latency"]["n_batches"]
    assert stats["decode_steps"] > 0
    assert set(stats["phase_s"]) == {"prefill", "decode"}


def test_pack_requests_and_pack_items_equal_reference():
    rng = np.random.default_rng(2)
    lens = rng.zipf(1.5, 64).clip(1, 500)
    reqs = [Request(i, np.zeros(int(n), np.int32)) for i, n in enumerate(lens)]
    jreqs = [JRequest(i, np.zeros(int(n), np.int32)) for i, n in enumerate(lens)]
    for n_batches in (1, 3, 4):
        a, s = pack_requests(reqs, n_batches)
        ja, js = j_pack_requests(jreqs, n_batches)
        np.testing.assert_array_equal(a, ja)
        np.testing.assert_array_equal(s.pop("loads"), js.pop("loads"))
        assert s == js
    work = rng.random(33) * 10
    a, s = pack_items(work, 5)
    ja, js = j_pack_items(work, 5)
    np.testing.assert_array_equal(a, ja)
    np.testing.assert_array_equal(s.pop("loads"), js.pop("loads"))
    assert s == js


def test_greedy_serving_is_deterministic_across_packings():
    eng, _, cfg = _engines("gemma-2b")
    reqs = [Request(i, p, 6) for i, p in enumerate(_prompts(cfg, (5, 5, 5), seed=0))]
    out1, _ = eng.serve(reqs, n_batches=1)
    out2, _ = eng.serve(reqs, n_batches=2)
    for i in range(3):
        np.testing.assert_array_equal(out1[i], out2[i])


def test_temperature_sampling_is_seeded():
    outs = []
    for _ in range(2):
        eng, _, cfg = _engines("gemma-2b", temperature=1.0)
        reqs = [Request(i, p, 8) for i, p in enumerate(_prompts(cfg, (5, 7), seed=3))]
        out, _ = eng.serve(reqs, n_batches=1)
        outs.append(out)
        for o in out.values():
            assert ((o >= 0) & (o < cfg.vocab_size)).all()
    for rid in outs[0]:
        np.testing.assert_array_equal(outs[0][rid], outs[1][rid])


def test_generate_batch_rejects_mixed_lengths():
    eng, _, cfg = _engines("gemma-2b")
    reqs = [Request(i, p, 2) for i, p in enumerate(_prompts(cfg, (4, 5), seed=0))]
    with pytest.raises(ValueError, match="equal prompt lengths"):
        eng.generate_batch(reqs)


def test_serve_cli_runs_on_cpu_and_prints_its_line():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve_cli.main(["--workload", "lm", "--arch", "gemma3-4b", "--device",
                        "cpu", "--requests", "3", "--max-new", "3"])
    line = buf.getvalue()
    assert line.startswith("[serve] gemma3-4b on cpu: 3 requests in"), line
    assert "pack eff" in line and "answer p50" in line


def test_serve_cli_fim_workload_is_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP item 8"):
        serve_cli.main(["--workload", "fim"])


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_cli.main(["--workload", "lm", "--requests", "1"])
