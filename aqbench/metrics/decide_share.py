"""Percent of the publish walls spent in the dedup stores' decision
(``DedupStore.decide_s`` of both stores over the harness's publish spans)."""


def read(rec):
    wall = sum(rec["seconds"].get("publish", []))
    if wall <= 0:
        return None
    return 100.0 * rec["counters"]["decide_s"] / wall
