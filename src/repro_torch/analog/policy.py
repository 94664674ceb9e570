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
from typing import Callable, List, Mapping, Optional, Sequence, Tuple

from repro_torch.core.device import RPUConfig

#: Rule config meaning "keep the matched layers digital".
DIGITAL = None

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

    def resolve(self, path: str) -> Optional[RPUConfig]:
        """Device config for a layer path; ``None`` means digital."""
        rule = self.match(path)
        return None if rule is None else rule.cfg

    def label_for(self, path: str) -> str:
        rule = self.match(path)
        if rule is None or rule.cfg is None:
            return "digital"
        return rule.label

    @staticmethod
    def uniform(cfg: RPUConfig, name: str = "uniform") -> "AnalogPolicy":
        """Every matched layer gets ``cfg``."""
        return AnalogPolicy(rules=(AnalogRule("*", cfg, name),))

    @staticmethod
    def exact(layer_cfgs: Mapping[str, Optional[RPUConfig]],
              default: Optional[RPUConfig] = None) -> "AnalogPolicy":
        """Literal layer-name rules, each labelled by its name, then
        ``default`` for every other path."""
        rules: List[AnalogRule] = [
            AnalogRule(_escape_glob(name), cfg, name)
            for name, cfg in layer_cfgs.items()]
        if default is not None:
            rules.append(AnalogRule("*", default, "default"))
        return AnalogPolicy(rules=tuple(rules))

    @staticmethod
    def of(*rules: Sequence) -> "AnalogPolicy":
        """``AnalogPolicy.of((pattern, cfg[, name]), ...)``."""
        return AnalogPolicy(rules=tuple(
            AnalogRule(r[0], r[1], r[2] if len(r) > 2 else "")
            for r in rules))

    def prepend(self, pattern: str, cfg: Optional[RPUConfig],
                name: str = "") -> "AnalogPolicy":
        """A higher-priority rule in front (first match wins)."""
        return AnalogPolicy(rules=(AnalogRule(pattern, cfg, name),)
                            + self.rules)

    def map_configs(self, fn: Callable[[RPUConfig], RPUConfig]
                    ) -> "AnalogPolicy":
        """Every rule's config through ``fn`` (digital rules pass)."""
        return AnalogPolicy(rules=tuple(
            dataclasses.replace(r, cfg=None if r.cfg is None else fn(r.cfg))
            for r in self.rules))

    def describe(self, paths: Sequence[str]) -> List[Tuple[str, str]]:
        """``(path, rule label)`` rows of a resolved-policy table."""
        return [(p, self.label_for(p)) for p in paths]

    def __bool__(self) -> bool:
        return bool(self.rules)


def _escape_glob(name: str) -> str:
    """A literal layer name as an exact glob (``*?[]`` bracketed)."""
    return "".join(f"[{ch}]" if ch in "*?[]" else ch for ch in name)
