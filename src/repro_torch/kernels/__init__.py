"""Hand-written Hopper kernels for the two device-heavy steps of a tick.

xorshift_proj — ODLHash projection: alpha generated tile by tile inside the
                kernel from the counter-based Xorshift16 hash, never stored.
oselm_update  — fused rank-k RLS update: each P element read once and
                written once for both the downdate and the beta update.
ops           — device dispatch (kernel on CUDA, plain version on CPU) and
                the launch counts.
ref           — the plain PyTorch version of each kernel.
build         — nvcc build of ``csrc/*.cu`` into ctypes-loaded libraries.
"""
