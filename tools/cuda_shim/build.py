#!/usr/bin/env python3
"""Build a kernel source of ``prost_tpu_torch/csrc`` for the CPU, to
rehearse it without a card.

    python3 tools/cuda_shim/build.py fused_vol OUT_DIR

writes ``OUT_DIR/fused_vol.so``: the source (and the ``csrc`` headers it
includes) compiled as C++20 by g++ against the stand-in runtime in
``include/``, one pthread per CUDA thread (``__syncthreads`` and
``grid.sync()`` are barriers over a block's and a launch's threads, a
streaming launch runs its blocks one after another on one set of
threads, a cooperative one all at once, dynamic shared memory is filled
with NaN).  Load it with
ctypes and call its C entry points with host (numpy) buffers; the extra
``shim_set_sms(n)`` sets the SM count a resident launch sees (so bands of
1 to n rows, and empty bands, can be tried), and ``shim_set_reverse(1)``
runs a streaming launch's blocks last to first (a block that writes what
a block before it in the grid still reads shows then).  It finds indexing and race
faults and holds one form of a kernel against another bit for bit (both
run the host's arithmetic); against the plain PyTorch versions expect a
few ulp (the host rounds rsqrtf and the sums otherwise).  Keep the SM
count small: a resident launch starts 512 threads a block.  Thread-block
clusters (``fused_rof.cu``'s batched chunk) compile but do not run: their
launch reports ``cudaErrorNotSupported``.
"""

import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "..", "..", "prost_tpu_torch", "csrc")


def convert(text: str) -> str:
    """A CUDA source as C++ for the stand-in runtime: launches through
    ``shim_launch``, the dynamic shared memory from the shim, casts of
    kernels to void* dropped (the cooperative launch unpacks its
    arguments by the kernel's type)."""
    text = text.replace("extern __shared__ float smem[];",
                        "float* smem = shim_smem;")
    text = text.replace("(const void*)", "")
    return re.sub(r"(\w+(?:<\w+>)?)<<<(.*?)>>>\((.*?)\);",
                  lambda m: (f"shim_launch({m.group(2)}, [=] "
                             f"{{ {m.group(1)}({m.group(3)}); }});"),
                  text, flags=re.S)


def build(name: str, out_dir: str) -> str:
    os.makedirs(out_dir, exist_ok=True)
    for fname in os.listdir(CSRC):
        if fname.endswith(".cuh"):
            with open(os.path.join(CSRC, fname)) as fh:
                text = convert(fh.read())
            with open(os.path.join(out_dir, fname), "w") as fh:
                fh.write(text)
    with open(os.path.join(CSRC, f"{name}.cu")) as fh:
        text = convert(fh.read())
    text += ('\nextern "C" void shim_set_sms(int n) { SHIM_SMS = n; }\n'
             'extern "C" void shim_set_reverse(int r) { SHIM_REVERSE = r; }\n')
    src = os.path.join(out_dir, f"{name}.cpp")
    with open(src, "w") as fh:
        fh.write(text)
    lib = os.path.join(out_dir, f"{name}.so")
    subprocess.run(["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-w",
                    "-fPIC", "-shared", "-I", os.path.join(HERE, "include"),
                    "-I", out_dir, "-o", lib, src], check=True)
    return lib


if __name__ == "__main__":
    print(build(sys.argv[1], sys.argv[2]))
