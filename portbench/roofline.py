"""The yardstick's arithmetic: the card's peaks, and the bytes and
operations of one call of a kernel entry point, counted from its own
arguments.

Bytes count each input once and each output once; operations count the
rulebook's valid hits, not its capacity.  A call's bound is
max(bytes / HBM bandwidth, operations / peak rate); a roofline share is
the sum of the calls' bounds over the sum of their device times.

Peaks: NVIDIA H100 SXM data sheet, dense: 989 TFLOP/s bf16 on the tensor
cores, 67 TFLOP/s f32 outside them, 3.35 TB/s of HBM3.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {'bfloat16': 989e12, 'float32': 67e12}
# the model FLOPs of a step are held against the bf16 tensor-core peak
MFU_PEAK = PEAK_FLOPS['bfloat16']


def _dtype_name(dtype) -> str:
    return str(dtype).split('.')[-1]


def _size(dtype) -> int:
    return {'bfloat16': 2, 'float16': 2, 'float32': 4, 'int32': 4,
            'int64': 8}[_dtype_name(dtype)]


def k1_call(feats, weight, rules) -> dict:
    """K1 ``rulebook_conv(feats (V_in, Cin), weight (K, Cin, Cout), rules
    (K, V_out))``: reads feats, weight (in feats' type) and the rules,
    writes (V_out, Cout) in feats' type; 2 x hits x Cin x Cout."""
    k, cin, cout = weight.shape
    v_in, v_out = feats.shape[0], rules.shape[1]
    e = _size(feats.dtype)
    return dict(bytes=v_in * cin * e + k * cin * cout * e
                + k * v_out * _size(rules.dtype) + v_out * cout * e,
                per_hit=2 * cin * cout, rules=rules,
                dtype=_dtype_name(feats.dtype))


def k5_call(feats, g, rules) -> dict:
    """K5 ``rulebook_conv_dw(feats (V_in, Cin), g (V_out, Cout), rules
    (K, V_out))``: reads feats, g (in feats' type) and the rules, writes
    (K, Cin, Cout) f32; 2 x hits x Cin x Cout."""
    k, v_out = rules.shape
    cin, cout = feats.shape[1], g.shape[1]
    e = _size(feats.dtype)
    return dict(bytes=feats.shape[0] * cin * e + v_out * cout * e
                + k * v_out * _size(rules.dtype) + k * cin * cout * 4,
                per_hit=2 * cin * cout, rules=rules,
                dtype=_dtype_name(feats.dtype))


def finish(call: dict, hits_of) -> dict:
    """A recorded call with its hits counted (``hits_of(rules)``)."""
    out = {k: v for k, v in call.items() if k != 'rules'}
    out['flops'] = call['per_hit'] * hits_of(call['rules'])
    return out


def bound_s(call: dict) -> float:
    return max(call['bytes'] / HBM_BYTES_PER_S,
               call['flops'] / PEAK_FLOPS[call.get('dtype', 'bfloat16')])
