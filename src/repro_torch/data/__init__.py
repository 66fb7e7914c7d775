from repro_torch.data.pipeline import (allocate_worker_indices,
                                       bilinear_resize, crop_tokens,
                                       epoch_global_batches, resize_images,
                                       stream_indices, worker_batches)
from repro_torch.data.plane import DataPlane, prefetch_iter
from repro_torch.data.synthetic import SyntheticImages, SyntheticTokens

__all__ = ["DataPlane", "SyntheticImages", "SyntheticTokens",
           "allocate_worker_indices", "bilinear_resize", "crop_tokens",
           "epoch_global_batches", "prefetch_iter", "resize_images",
           "stream_indices", "worker_batches"]
