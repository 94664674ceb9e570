"""Per-layer analog device policies.

An :class:`AnalogPolicy` is an **ordered** list of rules mapping layer-path
patterns to :class:`~repro_torch.core.device.RPUConfig`\\ s, resolved
first-match-wins over slash-joined parameter-tree paths
(``"layers/attn/q"``, ``"unembed"``, …) — the paper's *selective*
application of management and variability-reduction knobs to chosen layers.

Patterns are shell globs by default (``fnmatch``; ``*`` crosses ``/``) or
regular expressions when prefixed with ``re:`` (matched with
``re.search``).  A rule whose config is ``None`` pins the matched layers to
**digital**; a path matched by no rule stays digital too.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import re
from typing import Optional, Tuple

from repro_torch.core.device import RPUConfig

REGEX_PREFIX = "re:"


@dataclasses.dataclass(frozen=True)
class AnalogRule:
    """One ``pattern -> device config`` entry of a policy."""

    pattern: str
    cfg: Optional[RPUConfig]           # None => explicitly digital
    name: str = ""                     # preset/display name

    def matches(self, path: str) -> bool:
        if self.pattern.startswith(REGEX_PREFIX):
            return re.search(self.pattern[len(REGEX_PREFIX):],
                             path) is not None
        return fnmatch.fnmatchcase(path, self.pattern)

    @property
    def label(self) -> str:
        return self.name or self.pattern


@dataclasses.dataclass(frozen=True)
class AnalogPolicy:
    """Ordered first-match-wins mapping of layer paths to RPU configs."""

    rules: Tuple[AnalogRule, ...] = ()

    def match(self, path: str) -> Optional[AnalogRule]:
        """The first rule matching ``path`` (or None: unmatched = digital)."""
        for rule in self.rules:
            if rule.matches(path):
                return rule
        return None
