"""The tolerances that hold each CUDA kernel to its plain PyTorch version
(chip_smoke.py, the bench's kernel check, tests/test_torch_gpu.py). They are
the JAX suite's own: images as tests/test_pallas.py and
tests/test_rasterizer.py hold them, per-Gaussian gradients as
tests/test_rasterizer.py:119, pose gradients as tests/test_pose_fused.py:71."""

IMG_TOL = dict(atol=2e-5, rtol=1e-4)     # kernel 1's acc and final T
GRAD_TOL = dict(atol=5e-5, rtol=5e-3)    # kernel 2's per-slot rows and dpacked
# Kernel 3's per-tile partials cancel heavily, so each is held to this
# fraction of its sum |term| (~170 f32 epsilons) and GRAD_TOL's rtol.
PARTIAL_ATOL = 1e-5
POSE_TOL = dict(atol=1e-4, rtol=5e-4)    # dq, dT: rtol 5e-4 with a tiny atol
# BA's pose gradient through kernel 2: per component, this fraction of the
# per-Gaussian terms' sum |term| and POSE_TOL's rtol
BA_ATOL = 1e-5
