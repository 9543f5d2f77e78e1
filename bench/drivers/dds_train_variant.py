"""``dds_train`` under the variant the cell's traffic names
(``traffic["variant"]``, one of ``launch/variants.VARIANTS``) in place of
the configuration's: the same rounds, reference and comparison. A traced
run's timer also opens the model's block spans (``moe``), from the window
on."""
from __future__ import annotations

from types import SimpleNamespace

from . import dds_train


class Driver(dds_train.Driver):
    def __init__(self, run):
        config = dict(run.config, training=dict(run.config["training"],
                                                variant=run.cell["traffic"]["variant"]))
        super().__init__(SimpleNamespace(**dict(vars(run), config=config)))
        if self.timer is not None:
            self.timer.blocks = True
