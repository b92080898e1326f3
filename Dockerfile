# usher_jax container: the UShER-capability suite on JAX.
# Mirrors the reference's Dockerfile + install/installUbuntu.sh role
# (/root/reference/Dockerfile): a self-contained image whose build runs
# the full test pyramid (unit + parity tests on the 8-device virtual CPU
# mesh, vendored smoke goldens, multi-device dryrun).
#
#   docker build -t usher-jax .
#   docker run usher-jax usher-jax --help
#
# On NVIDIA GPU hosts, install jax with its CUDA plugin instead:
#   pip install 'jax[cuda12]'
# (or build FROM an image with the CUDA runtime and run ./install/install.sh
# --cuda), and check the card with `python chip_smoke.py`.

FROM python:3.11-slim

RUN apt-get update \
    && apt-get install -y --no-install-recommends g++ zlib1g-dev \
    && rm -rf /var/lib/apt/lists/*

WORKDIR /opt/usher_jax
COPY . .

RUN pip install --no-cache-dir jax flax optax chex einops numpy pytest \
    && pip install --no-cache-dir -e . \
    && python setup.py build_ext --inplace

# build-time verification: the same pyramid CI runs (vendored fixtures —
# no reference checkout inside the image)
RUN ./ci.sh

ENTRYPOINT []
CMD ["usher-jax", "--help"]
