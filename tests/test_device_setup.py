"""Device-independent rules of the GPU bring-up: exact float dots, the
compile-cache location, automatic meshing, and chip_smoke.py refusing to
report a result without a GPU."""

import glob
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest

from usher_jax.core.flat import FlatMAT
from usher_jax.ops import placement as dense
from usher_jax.ops import placement_sparse as sparse
from usher_jax.parallel import mesh as pmesh
from usher_jax.utils import instrument

from test_placement import random_mat, random_sample

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _f32_dots(ir_dir):
    """(precision, line) of every float32 dot_general in the dumped IR."""
    found = []
    for path in glob.glob(os.path.join(ir_dir, "*.mlir")):
        with open(path) as f:
            for line in f:
                if "stablehlo.dot_general" not in line or "xf32>" not in line:
                    continue
                m = re.search(r"precision = \[(\w+), (\w+)\]", line)
                found.append((m.groups() if m else ("DEFAULT", "DEFAULT"),
                              line.strip()))
    return found


def test_no_default_precision_f32_dots(tmp_path):
    """On the GPU a DEFAULT-precision float32 dot may run in TF32, exact
    only for integers below 2^11; the interval engine's integer sums ride
    float32 dots, so every one must ask for HIGHEST.  Lowers the interval
    programs (plain, grouped) and the placement steps (dense, sparse)."""
    from bench import full_genotype_inputs, synth_lineage_bigmat

    rng = np.random.default_rng(5)
    T, ref = random_mat(rng, n_leaves=20, n_positions=15)
    positions = np.array(sorted(ref), dtype=np.int64)
    refarr = np.array([ref[p] for p in positions.tolist()], dtype=np.uint8)
    flat = FlatMAT(T, positions, refarr, "c")
    samples = [random_sample(rng, ref) for _ in range(4)]
    st_dev, parent_dev = flat.sync()
    meta = flat.order_arrays()
    g, E, miss = flat.encode_samples(samples)
    pos, gval, kmiss = sparse.sparsify(samples, flat.pos_index, flat.P_pad)
    node_args = (st_dev, parent_dev, flat.root_slot, np.asarray(flat.ref),
                 meta["active"], meta["is_leaf"], meta["is_root_mask"],
                 meta["num_leaves"], meta["bfs_rank"])

    big = synth_lineage_bigmat(rng, 3000, 200, n_lineages=4, stem=5)
    leaves = np.setdiff1d(np.arange(big.N), big.parent)
    slots = rng.choice(leaves, size=12, replace=False).tolist()

    ir_dir = str(tmp_path / "ir")
    old_dump = jax.config.read("jax_dump_ir_to")
    old_cache = jax.config.jax_enable_compilation_cache
    jax.clear_caches()
    jax.config.update("jax_enable_compilation_cache", False)
    jax.config.update("jax_dump_ir_to", ir_dir)
    try:
        dense.placement_step(*node_args, g, E, miss)
        sparse.placement_step_sparse(*node_args, pos, gval, kmiss,
                                     pos.shape[1])
        big.place_arrays(*full_genotype_inputs(big, slots))
        big.place_arrays_grouped(*big.group_ancestral_batch(slots,
                                                            min_group=2))
    finally:
        jax.config.update("jax_dump_ir_to", old_dump)
        jax.config.update("jax_enable_compilation_cache", old_cache)
    dots = _f32_dots(ir_dir)
    assert dots, "no float32 dot lowered: the check saw nothing"
    loose = [line for prec, line in dots if prec != ("HIGHEST", "HIGHEST")]
    assert not loose, loose


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_rule(env_set, tmp_path, monkeypatch):
    """JAX_COMPILATION_CACHE_DIR set: JAX reads it and nothing is set here;
    unset: the cache is <repo>/.jax_cache."""
    before = jax.config.jax_compilation_cache_dir
    try:
        if env_set:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
            assert instrument.enable_compile_cache() is None
            assert jax.config.jax_compilation_cache_dir == before
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            want = os.path.join(REPO, ".jax_cache")
            assert instrument.enable_compile_cache() == want
            assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("backend,count,want,expect", [
    ("gpu", 4, -1, 4),     # auto: every GPU
    ("gpu", 1, -1, 0),     # one device: no mesh
    ("cpu", 8, -1, 0),     # the CPU never meshes by itself
    ("cpu", 8, 2, 2),      # an explicit request is taken as given
])
def test_auto_mesh_devices(backend, count, want, expect, monkeypatch):
    monkeypatch.setattr(pmesh.jax, "default_backend", lambda: backend)
    monkeypatch.setattr(pmesh.jax, "device_count", lambda: count)
    assert pmesh.auto_mesh_devices(want) == expect


def test_chip_smoke_fails_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
