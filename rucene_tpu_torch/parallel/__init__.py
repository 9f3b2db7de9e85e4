"""Multi-device: segment shards on a [shard, dp] grid of torch devices,
top-k merge, and several processes over torch.distributed."""
