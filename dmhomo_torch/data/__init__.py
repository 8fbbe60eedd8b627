"""Host-side data of the port.  The plain-image datasets of the
unconditional twin are exported here, as the JAX package exports them; the
other modules are imported by path."""

from dmhomo_torch.data.image_data import CifarDataset, GHOFTestDataset

__all__ = ["CifarDataset", "GHOFTestDataset"]
