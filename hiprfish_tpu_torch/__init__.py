"""hiprfish_tpu_torch — the PyTorch + CUDA port of hiprfish_tpu.

The JAX package ``hiprfish_tpu`` stays the reference; this package runs its
7-bit flagship FOV step (``pipeline/fused.py::fov_step``) in PyTorch, with
the four kernels of that path written by hand in CUDA C++ for Hopper
(``csrc/``, bound with ctypes in ``kernels/``):

  B1 csrc/nlm.cu       NL-means          (ops/denoise.py)
  B2 csrc/lpcv2d.cu    2D LP-CV          (ops/line_profile.py)
  B3 csrc/segstats.cu  per-label stats   (ops/segstats.py)
  B4 csrc/segstats.cu  per-pixel lookup  (ops/segstats.py)

Every module mirrors its counterpart under ``hiprfish_tpu`` and carries a
plain-torch version of each function; a kernel wrapper runs that plain
version on a CPU tensor and launches its kernel on a CUDA tensor. This
package imports neither jax nor anything of ``hiprfish_tpu``: the layout,
the segmentation defaults (``config.py``) and the synthetic FOVs
(``utils/synthetic.py``) are its own copies, which tests hold equal to the
reference's.
"""

__version__ = "0.1.0"
