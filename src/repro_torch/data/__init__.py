"""Data of the port: the synthetic image set and its loaders (the token
corpora and loaders follow with the training slice)."""

from repro_torch.data.images import (ImageLoader, eval_image_batches,
                                     synthetic_images)

__all__ = ["synthetic_images", "ImageLoader", "eval_image_batches"]
