"""K1 (``rulebook_conv``, csrc/conv.cu) in the traced train steps: the sum
of its calls' bounds (``roofline.bound_s``) over the device time of their
own K1 kernels, in %."""

from portbench.roofline import bound_s

# the kernels of one K1 call: the bf16 tensor-core conv, the f32 one, and
# the sum of a split call's f32 slabs
KERNELS = r'rulebook_conv_tc|gather_gemm|sum_partials'


def read(trace):
    calls = trace.calls.get('k1')
    if not calls:
        return None
    t = trace.device_time('k1', KERNELS)
    if t <= 0:
        return None
    return 100.0 * sum(bound_s(c['args']) for c in calls) / t
