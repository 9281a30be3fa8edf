"""The port's batch miner against the reference package's ``mine()``: the
full support maps and their checksums for every variant, workload mode,
``max_k`` bound and Phase-2 path, the guards, and one full-scale dataset
pinned to the checksum the card run checks."""
import dataclasses
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import EclatConfig as JConfig
from repro.core import bruteforce_fim as j_bruteforce
from repro.core import mine as j_mine
from repro.core import top_k_mine as j_top_k
from repro.core.eclat import resolve_min_sup as j_resolve

from repro_torch.core import EclatConfig, bruteforce_fim, mine, support_checksum, top_k_mine
from repro_torch.core import eclat as teclat
from repro_torch.core.eclat import resolve_min_sup
from repro_torch.data import generate

from test_eclat_correctness import make_db

DB = make_db()
ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

_SPEC = importlib.util.spec_from_file_location(
    "headline_bench", os.path.join(ROOT, "benchmarks", "headline_bench.py"))
_HEADLINE = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(_HEADLINE)
j_support_checksum = _HEADLINE.support_checksum


def _both(min_sup, **kw):
    got = mine(DB, 10, EclatConfig(min_sup=min_sup, **kw), device="cpu")
    want = j_mine(DB, 10, JConfig(min_sup=min_sup, **kw))
    return got, want


@pytest.mark.parametrize("variant", ["v1", "v2", "v3", "v4", "v5", "v6"])
@pytest.mark.parametrize("mode", ["all", "closed", "maximal"])
def test_mine_matches_reference(variant, mode):
    kw = dict(variant=variant, p=3, mode=mode, use_diffsets=(variant == "v6"))
    got, want = _both(20, **kw)
    assert got.support_map() == want.support_map()
    assert got.workload_map() == want.workload_map()
    assert got.counts == want.counts
    assert (support_checksum(got.support_map())
            == j_support_checksum(want.support_map()))
    for key in ("abs_min_sup", "n_freq_items", "n_words", "tri_matrix",
                "partition_balance", "n_intersections", "n_padded",
                "pair_padding", "mode", "mode_itemsets", "filter_reduction"):
        assert got.stats.get(key) == want.stats.get(key), key


@pytest.mark.parametrize("variant", ["v4", "v6"])
def test_ref_backend_and_no_compaction_agree(variant):
    """Both port backends agree with the reference mined with and without
    its survivor compaction (the port always compacts)."""
    for compact in (True, False):
        want = j_mine(DB, 10, JConfig(min_sup=35, variant=variant, p=3,
                                      compact=compact))
        for backend in ("fused", "ref"):
            got = mine(DB, 10, EclatConfig(min_sup=35, variant=variant, p=3,
                                           backend=backend), device="cpu")
            assert got.support_map() == want.support_map()
            assert got.stats["backend"] == backend


@pytest.mark.parametrize("max_k", [1, 2, 3, None])
@pytest.mark.parametrize("tri_matrix", [True, False])
def test_max_k_and_phase2_paths(max_k, tri_matrix):
    kw = dict(variant="v4", p=3, max_k=max_k, tri_matrix=tri_matrix,
              chunk_pairs=7, bucket_min=32)
    got, want = _both(20, **kw)
    assert got.support_map() == want.support_map()
    assert got.counts == want.counts
    assert got.stats.get("pair_padding") == want.stats.get("pair_padding")
    oracle = bruteforce_fim(DB, min_sup=20, max_k=max_k)
    assert got.support_map() == oracle


@pytest.mark.parametrize("min_sup", [0.3, 1.0, 0.003, 25, 2.0, 1])
def test_fractional_and_count_min_sup(min_sup):
    got, want = _both(min_sup, variant="v5", p=4)
    assert got.stats["abs_min_sup"] == want.stats["abs_min_sup"]
    assert got.support_map() == want.support_map()


def test_resolve_min_sup_boundaries():
    n = 200
    for v in (1.0, 0.5, 0.003, np.float64(1.0), 1, np.int64(1), 25, 2.0):
        assert resolve_min_sup(v, n) == j_resolve(v, n)
    assert resolve_min_sup(1.0, n) == n
    for bad in (0, -3, 0.0, -0.5, 10.7):
        with pytest.raises(ValueError):
            resolve_min_sup(bad, n)
    with pytest.raises(TypeError):
        resolve_min_sup(True, n)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_bruteforce_oracle_agrees(seed):
    rng = np.random.default_rng(seed)
    txns = [sorted(set(rng.integers(0, 7, rng.integers(1, 5)).tolist()))
            for _ in range(40)]
    oracle = bruteforce_fim(txns, min_sup=4)
    assert oracle == j_bruteforce(txns, min_sup=4)
    got = mine(txns, 7, EclatConfig(min_sup=4, variant="v6", p=2), device="cpu")
    assert got.support_map() == oracle


def test_top_k_matches_reference():
    got = top_k_mine(DB, 10, 15, config=EclatConfig(min_sup=1, p=3), device="cpu")
    want = j_top_k(DB, 10, 15, config=JConfig(min_sup=1, p=3))
    assert got.itemsets == want.itemsets
    assert got.ladder == want.ladder


def test_pinned_full_scale_checksum():
    """T10I4D100K at scale 1.0, min_sup 0.01, v4: both packages give the
    checksum that chip_smoke.py holds the card run to."""
    txns, spec = generate("T10I4D100K", scale=1.0, seed=0)
    cfg = dict(min_sup=0.01, variant="v4")
    got = mine(txns, spec.n_items, EclatConfig(**cfg), device="cpu")
    assert support_checksum(got.support_map()) == "a38431aa361588e6"
    assert got.counts == [187, 852, 608, 233, 78, 10, 1]
    want = j_mine(txns, spec.n_items, JConfig(**cfg))
    assert j_support_checksum(want.support_map()) == "a38431aa361588e6"


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------

def test_trimatrix_corruption_raises(monkeypatch):
    real = teclat.cooccurrence_counts

    def corrupt(bitmaps, *a, **kw):
        return real(bitmaps, *a, **kw) + 60

    monkeypatch.setattr(teclat, "cooccurrence_counts", corrupt)
    with pytest.raises(RuntimeError, match="tri-matrix pass is corrupt"):
        mine(DB, 10, EclatConfig(min_sup=60, variant="v4", p=3), device="cpu")


def test_package_imports_no_jax_and_no_reference_package():
    code = ("import sys, repro_torch, repro_torch.core.eclat, "
            "repro_torch.launch.mine, repro_torch.kernels, "
            "repro_torch.configs, repro_torch.models, repro_torch.serving, "
            "repro_torch.launch.serve, repro_torch.launch.serve_profile, "
            "repro_torch.streaming, repro_torch.faults, repro_torch.data.stream, "
            "repro_torch.serving.stream_query, repro_torch.launch.stream, "
            "repro_torch.launch.mesh_runs, repro_torch.launch.stream_profile; "
            "import repro_torch.configs as c; c.list_configs(); "
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'repro.')) or m == 'repro'); "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_default_device_is_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mine(DB, 10, EclatConfig(min_sup=20))


@pytest.mark.parametrize("field,value", [
    ("shard", "words"), ("block_w", 256), ("autotune", True),
    ("checkpoint_dir", "ckpt"), ("checkpoint_every_level", True)])
def test_unported_options_raise(field, value):
    cfg = dataclasses.replace(EclatConfig(min_sup=20), **{field: value})
    if field == "shard":
        # ported with the mesh backends: without a mesh the split has
        # nothing to split, and both packages mine on one device
        got = mine(DB, 10, cfg, device="cpu")
        want = j_mine(DB, 10, dataclasses.replace(JConfig(min_sup=20),
                                                  **{field: value}))
        assert got.support_map() == want.support_map()
        assert got.stats["backend"] == "fused"
        return
    with pytest.raises(NotImplementedError, match="not ported"):
        mine(DB, 10, cfg, device="cpu")


@pytest.mark.parametrize("backend", ["auto", "sharded"])
def test_unported_backends_raise(backend):
    if backend == "sharded":
        # ported: with no mesh it is the single-device default, as in the
        # reference (tests/test_torch_mesh.py runs it on a mesh)
        got = mine(DB, 10, EclatConfig(min_sup=20, backend=backend), device="cpu")
        want = j_mine(DB, 10, JConfig(min_sup=20, backend=backend))
        assert got.support_map() == want.support_map()
        assert (got.stats["backend"], want.stats["backend"]) == ("fused", "pallas")
        return
    with pytest.raises(NotImplementedError):
        mine(DB, 10, EclatConfig(min_sup=20, backend=backend), device="cpu")


def test_config_validation_matches_reference():
    for bad in (dict(use_diffsets=True, variant="v4"), dict(max_k=0),
                dict(mode="top")):
        with pytest.raises(ValueError):
            mine(DB, 10, EclatConfig(min_sup=20, **bad), device="cpu")
        with pytest.raises(ValueError):
            j_mine(DB, 10, JConfig(min_sup=20, **bad))


def test_launch_driver_prints_the_reference_summary():
    args = ["--dataset", "chess", "--scale", "0.1", "--min-sup", "0.8",
            "--mode", "closed"]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    out = {}
    for pkg, extra in (("repro_torch", ["--device", "cpu"]), ("repro", [])):
        res = subprocess.run([sys.executable, "-m", f"{pkg}.launch.mine", *args, *extra],
                             env=env, capture_output=True, text=True, timeout=300)
        assert res.returncode == 0, res.stderr
        line = [l for l in res.stdout.splitlines() if l.startswith("[mine]")][-1]
        head, tail = line.split(" itemsets in ")
        out[pkg] = (head, tail.split("s ", 1)[1])
    assert out["repro_torch"] == out["repro"]


def test_rules_match_reference():
    from repro.core import generate_rules as j_rules
    from repro_torch.core import generate_rules
    got, want = _both(35, variant="v4", p=3)
    assert (sorted(generate_rules(got.support_map(), 0.8))
            == sorted(j_rules(want.support_map(), 0.8)))
