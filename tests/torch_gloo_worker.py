"""A rank of a four-process gloo group for ``test_torch_sharding.py``: runs
the port's ``compressed_psum`` on its row of each case and puts the results
on a queue.  Kept apart from the test module so that a spawned rank imports
torch and the port only."""
import datetime

import numpy as np


def compressed_psum_rank(rank: int, world: int, store_path: str, cases, queue) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.sharding.collectives import compressed_psum

    timeout = datetime.timedelta(seconds=60)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world, timeout=timeout)
    try:
        out = []
        for stacked, dtype in cases:
            x = torch.from_numpy(np.asarray(stacked[rank], dtype=np.float32)).to(dtype)
            out.append(compressed_psum(x).numpy())
        queue.put((rank, out))
    finally:
        dist.destroy_process_group()
