"""b1_roofline.serve (kernels): B1's byte bound (B N 512 elements a call at
bf16 over 3.35 TB/s, summed over the reference's attention shapes of a
unit) over the device time of the kernels launched under the op
dyffusion_tpu_torch::linear_attention_qkv, in percent."""
from benchmark.metrics import _shares


def read(run):
    return _shares.roofline(run, "serve", "b1_bytes", lambda op: op.endswith("linear_attention_qkv"))
