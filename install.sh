#!/usr/bin/env bash
# Install pydca_tpu from this checkout into the current environment.
# Mirrors the reference's install.sh role (KIT-MBS/pydca install.sh).
set -euo pipefail

MIN=310
HAVE=$(python3 -c 'import sys; print(sys.version_info[0]*100+sys.version_info[1])')
if [ "${HAVE}" -lt "${MIN}" ]; then
    echo "ERROR: pydca_tpu needs Python >= 3.10 (found $(python3 -V))" >&2
    exit 1
fi

echo "Installing pydca_tpu (console scripts: mfdca, plmdca, pydca, a2m2aln)"
pip install -e "$(dirname "$0")"
echo "Done.  On an NVIDIA GPU host, install jax with its CUDA plugin first:"
echo '  pip install "jax[cuda12]>=0.9,<0.10"'
