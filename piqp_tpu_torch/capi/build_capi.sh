#!/bin/sh
# Build the port's C interface library and its C driver.
# Usage: sh piqp_tpu_torch/capi/build_capi.sh [outdir]
# outdir defaults to build/piqp_tpu_torch/capi/ at the repository root.
# Needs g++, gcc and python3-config; the CUDA kernels are built at their
# first use inside the embedded interpreter (piqp_tpu_torch/ops/_build.py).
set -e
HERE="$(cd "$(dirname "$0")" && pwd)"
OUT="${1:-$HERE/../../build/piqp_tpu_torch/capi}"
mkdir -p "$OUT"
OUT="$(cd "$OUT" && pwd)"
PYINC="$(python3-config --includes)"
PYLIB="$(python3-config --ldflags --embed)"

g++ -std=c++17 -O2 -fPIC -Wall $PYINC -I"$HERE" -shared \
    "$HERE/capi.cpp" -o "$OUT/libpiqp_tpu_torch_c.so" $PYLIB
gcc -std=c11 -O2 -Wall -I"$HERE" "$HERE/test_capi.c" -o "$OUT/test_capi" \
    -L"$OUT" -lpiqp_tpu_torch_c -Wl,-rpath,"$OUT" -lm
echo "built $OUT/libpiqp_tpu_torch_c.so and $OUT/test_capi"
