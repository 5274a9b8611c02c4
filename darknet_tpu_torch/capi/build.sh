#!/bin/sh
# Build the darknet_tpu_torch C ABI shim (embeds CPython) and link the
# unchanged demo client of native/capi against it: the two libraries
# share one API, so a client of either links against either.
# usage: build.sh [out_dir]   (default: darknet_tpu_torch/_build/capi)
set -e
HERE=$(cd "$(dirname "$0")" && pwd)
OUT=${1:-$HERE/../_build/capi}
mkdir -p "$OUT"
PYCFG=python3-config
CFLAGS="$($PYCFG --includes) -O2 -fPIC -Wall"
LDFLAGS="$($PYCFG --ldflags --embed 2>/dev/null || $PYCFG --ldflags)"
gcc $CFLAGS -shared -o "$OUT/libdarknet_tpu_torch_c.so" \
    "$HERE/darknet_tpu_torch_c.c" $LDFLAGS
# demo.c includes "darknet_tpu_c.h": give it the port's header by that
# name.  The demo saves its weights to the fixed path
# /tmp/dtpu_demo.weights; in this build that path goes to
# $DTPU_DEMO_WEIGHTS, else to $TMPDIR/dtpu_demo.weights, so that two runs
# never share one file.
cat > "$OUT/darknet_tpu_c.h" <<'EOF'
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include "darknet_tpu_torch_c.h"
static int dtpu_demo_save_weights(dtpu_net net, const char* path) {
  static char buf[4096];
  const char* to = getenv("DTPU_DEMO_WEIGHTS");
  const char* tmp = getenv("TMPDIR");
  if (strcmp(path, "/tmp/dtpu_demo.weights") == 0) {
    if (to && to[0]) {
      path = to;
    } else if (tmp && tmp[0]) {
      snprintf(buf, sizeof buf, "%s/dtpu_demo.weights", tmp);
      path = buf;
    }
  }
  return dtpu_save_weights(net, path);
}
#define dtpu_save_weights dtpu_demo_save_weights
EOF
# a copy of the client, so that its #include "darknet_tpu_c.h" finds the
# header above before the one beside the original
cp "$HERE/../../native/capi/demo.c" "$OUT/demo.c"
gcc $CFLAGS -o "$OUT/dtpu_demo" "$OUT/demo.c" \
    -I"$OUT" -I"$HERE" -L"$OUT" -ldarknet_tpu_torch_c \
    -Wl,-rpath,"$OUT" $LDFLAGS
echo "$OUT/dtpu_demo"
