#!/usr/bin/env bash
# CI for usher_jax: unit+parity tests on the virtual CPU mesh, the smoke
# end-to-end workflow, and the multi-device dryrun.  (The reference's CI only
# runs --help on each binary, .github/workflows/cmake.yml:19-25; this runs
# the real test pyramid.)
#
# USHER_REF_ROOT points at a checkout of the reference repo (for its
# test/ fixtures); stages that need those fixtures are skipped when it is
# absent (e.g. hosted GitHub runners).
set -euo pipefail
cd "$(dirname "$0")"

REF=${USHER_REF_ROOT:-/root/reference}
# hosted runners have no reference checkout: the smoke fixtures are vendored
# (tests/fixtures/, byte-identical copies) so the golden stages always run
if [ ! -f "$REF/test/global_phylo.nh" ]; then
  REF="$PWD/tests/fixtures/asref"
  mkdir -p "$REF/test"
  cp tests/fixtures/global_phylo.nh tests/fixtures/global_samples.vcf \
     tests/fixtures/new_samples.vcf "$REF/test/"
fi

echo "== unit + parity tests (8-device virtual CPU mesh) =="
python -m pytest tests/ -q

if [ -f "$REF/test/global_phylo.nh" ]; then
  echo "== smoke end-to-end (reference fixtures) =="
  TMP=$(mktemp -d)
  trap 'rm -rf "$TMP"' EXIT
  JAX_PLATFORMS=${USHER_CI_PLATFORM:-cpu} python -m usher_jax.cli.usher_cli -t "$REF/test/global_phylo.nh" \
      -v "$REF/test/global_samples.vcf" -o "$TMP/out.pb" -d "$TMP/b" \
      --mesh-devices 0 2> "$TMP/build.log"
  JAX_PLATFORMS=${USHER_CI_PLATFORM:-cpu} python -m usher_jax.cli.usher_cli -i "$TMP/out.pb" \
      -v "$REF/test/new_samples.vcf" -o "$TMP/out2.pb" -d "$TMP/p" \
      --mesh-devices 0 2> "$TMP/place.log"
  test -s "$TMP/p/placement_stats.tsv"
  cmp "$TMP/p/placement_stats.tsv" tests/goldens/smoke_placement_stats.tsv
  cmp "$TMP/p/final-tree.nh" tests/goldens/smoke_final_tree.nh
  echo "smoke goldens OK"

  echo "== smoke end-to-end on the 8-device virtual mesh (must match the =="
  echo "== single-device goldens byte-for-byte) =="
  XLA_FLAGS="--xla_force_host_platform_device_count=8" \
  JAX_PLATFORMS=${USHER_CI_PLATFORM:-cpu} python -m usher_jax.cli.usher_cli -i "$TMP/out.pb" \
      -v "$REF/test/new_samples.vcf" -o "$TMP/out3.pb" -d "$TMP/pm" \
      --mesh-devices 8 2> "$TMP/place_mesh.log"
  cmp "$TMP/pm/placement_stats.tsv" tests/goldens/smoke_placement_stats.tsv
  cmp "$TMP/pm/final-tree.nh" tests/goldens/smoke_final_tree.nh
  echo "mesh smoke goldens OK"

  echo "== workflow smoke (usher + systematic run types) =="
  JAX_PLATFORMS=${USHER_CI_PLATFORM:-cpu} python workflows/run.py --runtype systematic \
      --vcf "$REF/test/new_samples.vcf" --pb "$TMP/out.pb" \
      --outdir "$TMP/wf" 2> "$TMP/wf.log"
  test -s "$TMP/wf/parsimony_report.txt"
  echo "workflow smoke OK"
else
  echo "== skipping reference-fixture smoke stages ($REF/test not present) =="
fi

echo "== multi-device dryrun (8 virtual devices) =="
XLA_FLAGS="--xla_force_host_platform_device_count=8" JAX_PLATFORMS=cpu python -c "
import jax
import sys; sys.path.insert(0, '.')
from __graft_entry__ import entry, dryrun_multichip
fn, args = entry(); jax.jit(fn)(*args)
dryrun_multichip(8)
print('multi-device dryrun OK')"

echo "CI PASSED"
