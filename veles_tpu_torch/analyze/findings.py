"""Structured findings: the analyzer's one output type.

The port's copy of :mod:`veles_tpu.analyze.findings`.  Every pass (in
the JAX package: the graph doctor, the JAX hazard analyzer and the
lint pack; in the port so far: the generative serving preflight, rule
V-S01) emits
:class:`Finding` records; :class:`Report` collects them, orders them by
severity, and renders text for terminals and JSON for tooling.  The
serve pre-flight and the ``--analyze`` launcher flag key their exit
behaviour off :attr:`Report.has_errors` — severity is the contract,
not the prose.
"""

import json

#: Ordered worst-first; index = sort key.
SEVERITIES = ("error", "warning", "info")


class Finding(object):
    """One diagnostic: ``(severity, rule, unit, location, message, fix)``.

    ``rule`` is a stable ID from the catalog (``V-Gxx`` graph doctor,
    ``V-Jxx`` JAX hazards, ``V-Lxx`` lint pack) so tooling can filter
    without parsing prose.  ``location`` is a ``file:line`` string when
    the finding anchors to source, else ``None``; ``unit`` names the
    workflow unit involved, else ``None``.
    """

    __slots__ = ("severity", "rule", "message", "unit", "location", "fix")

    def __init__(self, severity, rule, message, unit=None, location=None,
                 fix=None):
        if severity not in SEVERITIES:
            raise ValueError("unknown severity %r (want one of %s)"
                             % (severity, ", ".join(SEVERITIES)))
        self.severity = severity
        self.rule = rule
        self.message = message
        self.unit = unit
        self.location = location
        self.fix = fix

    def to_dict(self):
        return {"severity": self.severity, "rule": self.rule,
                "unit": self.unit, "location": self.location,
                "message": self.message, "fix": self.fix}

    def render(self):
        parts = ["%-7s %s" % (self.severity, self.rule)]
        if self.unit:
            parts.append("[%s]" % self.unit)
        if self.location:
            parts.append(self.location)
        parts.append(self.message)
        line = " ".join(parts)
        if self.fix:
            line += "\n          fix: %s" % self.fix
        return line

    def __repr__(self):
        return "<Finding %s %s %s>" % (self.severity, self.rule,
                                       self.unit or self.location or "")


class Report(object):
    """Ordered collection of findings from one analyzer invocation."""

    def __init__(self, findings=(), passes=()):
        self.findings = list(findings)
        self.passes = list(passes)

    def extend(self, findings):
        self.findings.extend(findings)
        return self

    def __iter__(self):
        return iter(self.sorted())

    def __len__(self):
        return len(self.findings)

    def sorted(self):
        return sorted(
            self.findings,
            key=lambda f: (SEVERITIES.index(f.severity), f.rule,
                           f.location or "", f.unit or ""))

    @property
    def has_errors(self):
        return any(f.severity == "error" for f in self.findings)

    def errors(self):
        return [f for f in self.findings if f.severity == "error"]

    def rules(self):
        """Distinct rule IDs present, sorted."""
        return sorted({f.rule for f in self.findings})

    def counts(self):
        out = dict.fromkeys(SEVERITIES, 0)
        for f in self.findings:
            out[f.severity] += 1
        return out

    def render_text(self):
        if not self.findings:
            return "analyze: clean (%s)" % ", ".join(self.passes or
                                                     ("no passes",))
        lines = [f.render() for f in self.sorted()]
        counts = self.counts()
        lines.append("analyze: %d error(s), %d warning(s), %d info "
                     "across %s" % (counts["error"], counts["warning"],
                                    counts["info"],
                                    ", ".join(self.passes) or "?"))
        return "\n".join(lines)

    def to_json(self, indent=2):
        return json.dumps({
            "passes": self.passes,
            "counts": self.counts(),
            "rules": self.rules(),
            "findings": [f.to_dict() for f in self.sorted()],
        }, indent=indent)


def rule_catalog():
    """The rule catalog: ``{rule_id: (severity, description)}``,
    aggregated from every pass module the port has.  Only V-S01 is
    ported; the graph, plan and lint passes and the rest of the shape
    pass wait for ROADMAP item 7(e)."""
    from veles_tpu_torch.analyze import shapes
    return dict(shapes.RULES)
