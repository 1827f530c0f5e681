"""Percent of hot-chunk requests to the node server answered by a read that
a restore of another snapshot made (``HotChunkCache`` cross-group hits over
the requests the harness counted at ``NodePageServer.hot_chunk``): dedup
variants sharing their base's hot chunks."""


def read(rec):
    req = rec["counters"].get("hot_chunk_requests", 0)
    hits = rec["counters"].get("cross_snapshot_hits")
    if not req or hits is None:
        return None
    return 100.0 * hits / req
