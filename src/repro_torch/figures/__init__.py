"""The paper's figures as campaign specs, on the port (``launch.campaign``).

One module per figure, named as the reference's ``benchmarks/fig*.py``;
importing this package registers them all (``fig2``, ``fig3``, ``fig6``,
``fig7``, ``fig8``, ``fig9``, ``fig10``, ``fig_overlap``). ``common`` holds
the scale tiers and the default figure set; ``run`` is the CLI.
"""
from . import (fig2_cdf, fig3_correlation, fig6_7_cifar,  # noqa: F401 (registration)
               fig8_mnist, fig9_epochs_to_target, fig10_consensus, fig_overlap)
