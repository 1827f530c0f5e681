"""A dedup fleet (``benchmarks/dedup_bench.py``'s ``make_fleet``): one base
image of the paper's page mix; variant ``v`` keeps the base's hot pages but
``d = round(n_hot * hot_delta_per_256 / 256)`` of them, from rank ``v * d``
round the hot set, and draws them and its whole cold arena from
``(seed, v)``; a later version draws its ``d`` hot pages anew."""
import torch

from aqbench import gen


class Images:
    def __init__(self, cfg: dict, seed: int, device):
        self.seed = int(seed)
        self.base, self.hot = gen.make_image(int(cfg["image_pages"]), cfg["page_mix"],
                                             gen.sub_seed(seed, 0), device)
        self.hot_t, self.cold_t = gen.page_classes(self.base, self.hot)
        self.d = gen.delta_pages(int(self.hot_t.numel()), int(cfg["hot_delta_per_256"]))

    def image(self, v: int, version: int) -> tuple:
        """``(buf, hot)`` of variant ``v`` at ``version``."""
        buf = self.base.clone()
        own = gen.delta_rows(self.hot_t, self.d, v)
        gen.fill_rows(buf, torch.cat([own, self.cold_t]), gen.sub_seed(self.seed, 1, v))
        if version:
            gen.fill_rows(buf, own, gen.sub_seed(self.seed, 2, v, version))
        return buf, self.hot
