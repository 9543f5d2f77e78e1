"""One view over every string-keyed registry of the port.

Counterpart of ``repro.registries``. Every scenario/execution knob resolves
through a registry: algorithms, road networks, mobility models, execution
backends, contact formats, and campaign figures. Each registered entry
carries a one-line summary (its docstring's first line; a figure's
``title``); ``render_markdown()`` gives the tables in the reference's
layout. The figures are the port's own (``repro_torch.figures``).

    python -m repro_torch.registries        # prints the markdown tables
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from .core import contacts as contacts_lib
from .fed import backends as backends_lib
from .fed import mobility as mobility_lib
from .fed import topology as topology_lib
from .fed.algorithms import base as algorithms_base
from .launch import campaign as campaign_lib

BEGIN_MARK = "<!-- registry-tables:begin"
END_MARK = "<!-- registry-tables:end -->"


@dataclass(frozen=True)
class RegistrySpec:
    """Where a registry lives and how an entry is addressed."""
    title: str
    module: str
    how: str                       # decorator -> knob
    entries: Callable[[], dict]    # name -> registered object
    doc_of: Callable[[object], str | None] = lambda obj: obj.__doc__


def _load_figures() -> None:
    """Figures register from ``repro_torch/figures/fig*.py``."""
    from . import figures  # noqa: F401 — importing registers the figures


REGISTRIES: tuple[RegistrySpec, ...] = (
    RegistrySpec("algorithms", "fed/algorithms/",
                 "`@register_algorithm` → `cfg.algorithm`",
                 algorithms_base.algorithm_registry),
    RegistrySpec("road networks", "fed/topology.py",
                 "`@register_road_network(name)` → `cfg.road_net`",
                 topology_lib.road_network_registry),
    RegistrySpec("mobility models", "fed/mobility.py",
                 "`@register_mobility(name)` → `cfg.mobility`",
                 mobility_lib.mobility_registry),
    RegistrySpec("execution backends", "fed/backends.py",
                 "`register_backend` → `cfg.backend`",
                 backends_lib.backend_registry),
    RegistrySpec("contact formats", "core/contacts.py",
                 "`register_contact_format` → `cfg.contact_format`",
                 contacts_lib.contact_format_registry),
    RegistrySpec("campaign figures", "launch/campaign.py",
                 "`register_figure` → `--figures`",
                 campaign_lib.figure_registry,
                 doc_of=lambda spec: getattr(spec, "title", None)),
)


def one_liner(spec: RegistrySpec, obj) -> str:
    """The entry's one-line summary: first docstring line (or figure title)."""
    doc = spec.doc_of(obj) or ""
    return doc.strip().splitlines()[0].strip() if doc.strip() else ""


def registry_entries() -> dict[str, list[tuple[str, str]]]:
    """{registry title: [(name, one-line summary), ...]} — sorted names."""
    _load_figures()
    return {
        spec.title: [(name, one_liner(spec, obj))
                     for name, obj in sorted(spec.entries().items())]
        for spec in REGISTRIES
    }


def render_markdown() -> str:
    """The ARCHITECTURE.md registry-reference block, markers included."""
    _load_figures()
    lines = [f"{BEGIN_MARK} — generated by `python -m repro_torch.registries` "
             "-->", ""]
    for spec in REGISTRIES:
        lines.append(f"### {spec.title} — `{spec.module}` · {spec.how}")
        lines.append("")
        lines.append("| name | summary |")
        lines.append("|---|---|")
        for name, obj in sorted(spec.entries().items()):
            lines.append(f"| `{name}` | {one_liner(spec, obj)} |")
        lines.append("")
    lines.append(END_MARK)
    return "\n".join(lines)


if __name__ == "__main__":
    print(render_markdown())
