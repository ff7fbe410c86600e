"""K5 (``rulebook_conv_dw``, csrc/conv.cu) in the traced train steps: the
sum of its calls' bounds over the device time of their own K5 kernels, in
%."""

from portbench.roofline import bound_s

# the kernels of one K5 call: the bf16 tensor-core weight gradient, the f32
# one, and the sum of a split call's f32 slabs
KERNELS = r'conv_dw_tc|conv_dw_fma|sum_partials'


def read(trace):
    calls = trace.calls.get('k5')
    if not calls:
        return None
    t = trace.device_time('k5', KERNELS)
    if t <= 0:
        return None
    return 100.0 * sum(bound_s(c['args']) for c in calls) / t
