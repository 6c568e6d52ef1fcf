"""Layer: q-gram filter, ops/qfilter.py.  Device ms a call of the filter's
kernels: the presence scatter, the candidate product and the top-k, found
by the kernel-name groups below."""

import re

# The kernels' names as PyTorch 2.11 (CUDA 12.8) names them on the H100:
# scatter_(1, ids, 1.0) is the fill form of the scatter kernel (the
# profiles' scatter_add_ is another); the float32 product is cuBLAS's FFMA
# GEMM; topk runs the multi-block radix select and sorts its k results.
GROUPS = {
    "presence": re.compile(r"_cuda_scatter_fill_internal_kernel"),
    "product": re.compile(r"gemm|xmma|cutlass", re.IGNORECASE),
    "topk": re.compile(r"mbtopk::|sbtopk::|gatherTopK|"
                       r"bitonicSortKVInPlace<[^>]*\bfloat, long\b"),
}


def read(ctx):
    if ctx.trace is None or not ctx.calls:
        return None
    secs = ctx.device_seconds(
        lambda name: any(g.search(name) for g in GROUPS.values()))
    return 1e3 * secs / len(ctx.calls) if secs > 0 else None
