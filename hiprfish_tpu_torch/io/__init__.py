"""Host I/O of the port: image planes in, CSV / npy / PNG artifacts out
(numpy only; no pandas, matplotlib or imageio at import time)."""
