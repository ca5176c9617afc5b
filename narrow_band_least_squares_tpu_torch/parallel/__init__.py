from narrow_band_least_squares_tpu_torch.parallel.sharded import ShardedNarrowBandPipeline

__all__ = ["ShardedNarrowBandPipeline"]
