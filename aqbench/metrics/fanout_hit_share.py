"""Percent of hot-chunk requests to the node server answered by another
restore's read of the same chunk (``HotChunkCache`` fan-out hits over the
requests the harness counted at ``NodePageServer.hot_chunk``)."""


def read(rec):
    req = rec["counters"].get("hot_chunk_requests", 0)
    if not req:
        return None
    return 100.0 * rec["counters"]["fanout_hits"] / req
