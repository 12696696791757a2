"""hash.encode_roofline: the hash encoding's kernel pair (csrc/hash_grid.cu)
against its bound, in %.

The bound of one call is its family's ``hash_bound_s`` (``reference/
hashmlp.py``): the larger of its weighted sums over the float32 peak and
its bytes (points, features or their gradient, and once each of the rows
a batch of evenly spread points touches at each level; backward, those
rows read and written) over the memory bandwidth.
Every call is one batch: the training steps' and the validation batches'.
The reading is the sum over ``hash_encode_fwd_kernel`` and
``hash_encode_bwd_kernel`` of that bound times the kernel's calls in the
``training_loop`` span, over their summed device time there. None where
they did not run.
"""

PER_STEP = ("hash_encode_bwd_kernel",)


def read(r):
    span = r.device_span()
    bounds = r.work.get("hash_bound_s")
    if span is None or not bounds:
        return None
    lo, hi = span
    need = seconds = 0.0
    for kernel, bound in bounds.items():
        micros, n = r.trace.kernel_time(kernel, lo, hi)
        need += bound * n
        seconds += micros / 1e6
    return 100.0 * need / seconds if seconds else None
