"""Images of independent functions: function ``f`` is the paper's page mix
drawn from ``(seed, f)``, in one version."""
from aqbench import gen


class Images:
    def __init__(self, cfg: dict, seed: int, device):
        self.n_pages, self.mix = int(cfg["image_pages"]), cfg["page_mix"]
        self.seed, self.device = int(seed), device

    def image(self, f: int, version: int) -> tuple:
        """``(buf, hot)`` of function ``f``."""
        if version:
            raise ValueError("independent images have one version")
        return gen.make_image(self.n_pages, self.mix, gen.sub_seed(self.seed, 0, f), self.device)
