#!/usr/bin/env bash
# Install usher_jax into the current Python environment (the reference's
# install/installUbuntu.sh analog — but a pip install, not a CMake build).
#
#   ./install/install.sh          # CPU jax (tests, host tools)
#   ./install/install.sh --cuda   # jax with its CUDA 12 plugin (NVIDIA GPUs)
#
# Installs the console scripts usher-jax, matUtils-jax, matOptimize-jax,
# ripples-jax and builds the native C++ host-tool extension
# (usher_jax/native: threaded VCF ingest, transposed-VCF codec, pb
# scanners).
set -euo pipefail
cd "$(dirname "$0")/.."

if [ "${1:-}" = "--cuda" ]; then
  pip install 'jax[cuda12]'
else
  pip install jax
fi
pip install flax optax chex einops numpy pytest
pip install -e .
python setup.py build_ext --inplace

echo "usher_jax installed; run: usher-jax --help"
echo "verify: ./ci.sh"
