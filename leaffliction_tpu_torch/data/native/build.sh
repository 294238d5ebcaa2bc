#!/bin/sh
# Build the native JPEG helper: build.sh <output .so>. The library is written
# under a temporary name and renamed, so a concurrent reader never loads a
# half-written file.
set -e
out="$1"
mkdir -p "$(dirname "$out")"
g++ -O3 -march=native -shared -fPIC -o "$out.$$" "$(dirname "$0")/decoder.cpp" -ljpeg
mv "$out.$$" "$out"
echo "built $out"
