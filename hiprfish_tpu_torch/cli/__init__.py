"""Command lines of the port, flag-compatible with the JAX package's
(hiprfish_tpu/cli/), with one flag more, ``--device`` (default cuda):

python -m hiprfish_tpu_torch.cli.measure              (10-bit measurement)
python -m hiprfish_tpu_torch.cli.classify             (10-bit classification)
python -m hiprfish_tpu_torch.cli.measure_multispecies (7-bit measurement)
python -m hiprfish_tpu_torch.cli.classify_spectra     (7-bit classification)
python -m hiprfish_tpu_torch.cli.biofilm              (biofilm 2D, z-slice, 3D)
python -m hiprfish_tpu_torch.cli.train                (classifier training)
python -m hiprfish_tpu_torch.cli.workflow             (measure -> classify ->
                                                       collect over a table)

and, with no device work and no --device flag:

python -m hiprfish_tpu_torch.cli.collect              (error rates, abundance)
python -m hiprfish_tpu_torch.cli.summarize_mix        (abundance figures)
python -m hiprfish_tpu_torch.cli.summarize_titration  (titration regression)
python -m hiprfish_tpu_torch.cli.analyze_multispecies (per-taxon error rates)
"""

import torch


def resolve_classifier_path(path: str) -> str:
    """Map the reference's .pkl filename conventions onto the .npz
    artifact."""
    if path.endswith(".pkl"):
        return path[: -len(".pkl")] + ".npz"
    return path


def resolve_device(name: str) -> torch.device:
    """The --device flag as a torch device; cuda without a card raises
    (no command line falls back to the CPU)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"--device {name}: expected cuda or cpu")
    return dev


def add_device_flag(parser) -> None:
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (cuda, cuda:N or cpu)")
