#!/usr/bin/env bash
# Reproduce the checks end to end.
#
#   bash tools/repro.sh            # CPU parts anywhere; GPU parts need a card
#
# Individual pieces:
#   python chip_smoke.py                     the main path on one GPU
#   python chip_smoke.py --multi             --mesh 4x1 and --distributed on 4
#   python bench.py                          device time per frame, one GPU
#   python tools/ring_bench.py --batch       shm ingest throughput
#   python -m pytest tests/ -q               the suite (forced-CPU 8-dev mesh)
set -euo pipefail
cd "$(dirname "$0")/.."

echo "== native build =="
make -s -C native

echo "== test suite (virtual 8-device CPU mesh) =="
python -m pytest tests/ -q

echo "== multichip dry run (8 virtual CPU devices) =="
JAX_PLATFORMS=cpu XLA_FLAGS="--xla_force_host_platform_device_count=8" python - <<'EOF'
import jax
import __graft_entry__ as g
fn, args = g.entry()
jax.jit(fn)(*args)
g.dryrun_multichip(len(jax.devices()))
print("entry + dryrun OK")
EOF

echo "== antenna-scaling harness (virtual 8-device CPU mesh) =="
python tools/scaling_bench.py --virtual 8 --reps 2 --r-hi 7 --batch 1 \
    --out SCALING_repro.json

echo "== SNR waterfall (theory cross-check, small sweep) =="
python tools/waterfall.py --platform cpu --antennas 8 --fft 128 \
    --symbols 33 --cp 16 --num-taps 4 --snrs=0,10,20 --seeds 2 \
    --pipelines golden,composed,fast --out /tmp/WATERFALL_repro.json \
    --fail-above-db 0.5

echo "== ring ingest benchmark =="
python tools/ring_bench.py --batch --symbols 10100
python tools/ring_bench.py --batch --symbols 10100 --dtype sc16
python tools/ring_bench.py --batch --symbols 10100 --dtype sc16 --batch-write
python tools/ring_bench.py --decompose   # write-leg/read-leg split

echo "== accuracy gate (EVM vs golden) =="
python tools/gate.py

if python -c 'import jax, sys; sys.exit(jax.default_backend() != "gpu")'; then
  echo "== GPU: smoke, benchmark, per-symbol latency =="
  python chip_smoke.py
  python bench.py --cells composed/sc16,composed/f32,fast/sc16,fast/f32
  python tools/latency_probe.py
else
  echo "== no GPU: chip_smoke.py, bench.py and latency_probe.py skipped =="
fi

# Sustained-pressure soak (three processes, per-frame EVM verdict) at the
# reference geometry on a GPU host:
#   python tools/soak.py --seconds 120 --antennas 16 --fft-size 1024 \
#       --frame-len 101 --ring-dtype sc16 --sc16-native --rate 4e6
