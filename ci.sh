#!/usr/bin/env bash
# figdraw_tpu verification pipeline — the committed twin of the reference's
# .github/workflows/build-full.yml (7-leg matrix on software GL/Vulkan).
# Our legs: true-CPU full suite (the LLVMpipe analog; Pallas kernels run in
# interpret mode), golden-frame fidelity (XLA + Pallas interpret), the
# multichip dry run on a virtual 8-device mesh, and the native flattener
# build. Run from the repo root:
#
#   ./ci.sh            # everything
#   ./ci.sh fast       # -m "not slow": skips the heavyweight frame-loop
#                      # suites (pyproject.toml markers)
#   ./ci.sh quick      # smoke: goldens + dryrun only
#
# On a machine with a GPU, `python chip_smoke.py` compiles the Triton
# kernels and checks them against the XLA reference, and
# `FIGDRAW_TEST_GPU=1 python -m pytest -m gpu tests/` runs the GPU tests.
set -euo pipefail
cd "$(dirname "$0")"

export JAX_PLATFORMS=cpu

mode="${1:-full}"

echo "== native flattener build =="
python -c "import figdraw_tpu.native as n; assert n.available(), 'libfigdraw_flatten.so failed to build'; print('native OK')"

if [ "$mode" = "fast" ]; then
  echo "== fast suite (true CPU, -m 'not slow') =="
  python -m pytest tests/ -q -m "not slow"
elif [ "$mode" != "quick" ]; then
  echo "== full suite (true CPU) =="
  python -m pytest tests/ -q
else
  echo "== golden fidelity (XLA + Pallas interpret) =="
  python -m pytest tests/test_golden.py tests/test_golden_layers.py \
      tests/test_golden_overlay.py tests/test_shaping_reference_fonts.py -q
fi

echo "== multichip dry run (virtual 8-device mesh) =="
XLA_FLAGS=--xla_force_host_platform_device_count=8 N_DEVICES=8 \
    python __graft_entry__.py

echo "CI green"
