"""Hand-written Hopper kernels for the two device-heavy steps of a tick.

xorshift_proj — ODLHash projection on the tensor cores: alpha generated
                tile by tile inside the kernel from the counter-based
                Xorshift16 hash, never stored.
oselm_update  — rank-k RLS update: the single pass takes (P, beta, H, Y) and
                reads and writes each P element once; the two-stage route
                (torch small operands, then a fused pass) takes the shapes
                the single pass does not.
ops           — device dispatch (kernel on CUDA, plain version on CPU), the
                RLS route by shape, and the launch counts.
ref           — the plain PyTorch version of each kernel.
build         — nvcc build of ``csrc/*.cu`` into ctypes-loaded libraries.
"""
