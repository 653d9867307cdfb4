"""repro_torch.io — the dataset-level compression facade, on the card.

    import repro_torch.io as rio
    ds = rio.Dataset.from_arrays({"t2m": t2m, "u10": u10})
    rio.write(ds, "weather.cszh3", compression="lossy,abs,1e-3,predictor=auto")
    back = rio.read("weather.cszh3")
    one = rio.read_variable("weather.cszh3", "t2m", chunks=(0, 1))

The files are the JAX package's (``repro.io``): chunked multi-variable v3
streams with per-chunk random access, readable by either package. Lossy
chunks compress and decode on the card unless ``device="cpu"`` is passed.
See :mod:`repro_torch.io.rw` for the layout.
"""
from .dataset import Dataset, Variable, open_dataset  # noqa: F401
from .rw import manifest, parse_compression, read, read_variable, write  # noqa: F401
