"""QoS-aware scheduling for the solve server (``serving/server.py``).

The port's copy of ``mpi_petsc4py_example_tpu/serving/qos.py``, pure host
logic like the coalescer:

* **priority and deadline classes**: :class:`QoSClass` gives a request a
  priority tier and a default dispatch deadline; ``interactive`` (tier 0)
  and ``bulk`` (tier 100) ship, and unlabeled requests sit between them
  (:data:`DEFAULT_PRIORITY`), so single-class traffic keeps its FIFO order;
* **deadline-weighted scheduling**: :func:`schedule` groups a queue
  snapshot exactly as :func:`~.coalescer.coalesce` does and orders the
  batches by priority tier, earliest deadline, then arrival; the
  dispatcher sends one batch a pass, so an urgent arrival preempts queued
  bulk batches into the next pass, never an in-flight block;
* **priority shedding**: :func:`shed_victim` names the least urgent
  strictly-lower-priority pending request an arrival may displace when the
  admission queue is full; its future resolves with
  :class:`~..utils.errors.ServerOverloadedError` (``shed=True``).

:class:`AutoscalePolicy` turns the servers' queue-wait percentiles into
grow / shrink / rebalance decisions. It only decides; the fleet router
executes a decision (``serving/fleet.py``, ``SolveRouter.autoscale_step``).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..utils.options import global_options

#: priority tier of requests submitted without a QoS class: between
#: interactive (0) and bulk (100)
DEFAULT_PRIORITY = 50


@dataclass(frozen=True)
class QoSClass:
    """One service class: a priority tier (lower is more urgent) and a
    default dispatch deadline in seconds (0: none), applied when a
    submission names the class without its own deadline."""
    name: str
    priority: int
    deadline: float = 0.0
    description: str = ""


def builtin_classes() -> dict[str, QoSClass]:
    """The shipped classes, with their deadlines from the options database
    (``-qos_interactive_deadline``, ``-qos_bulk_deadline``)."""
    opt = global_options()
    return {
        "interactive": QoSClass(
            "interactive", 0,
            deadline=opt.get_real("qos_interactive_deadline", 0.0),
            description="p99-sensitive; preempts bulk at window "
                        "boundaries, shed last"),
        "bulk": QoSClass(
            "bulk", 100,
            deadline=opt.get_real("qos_bulk_deadline", 0.0),
            description="throughput batch traffic; yields windows to "
                        "interactive, shed first under overload"),
    }


def default_class_name() -> str:
    """The class assumed for unlabeled submissions (``-qos_default_class``;
    empty keeps them at the neutral tier)."""
    return str(global_options().get_string("qos_default_class", "") or "")


def resolve(qos: str | None,
            classes: dict[str, QoSClass]) -> QoSClass | None:
    """The :class:`QoSClass` of a submission's ``qos=`` label (or the
    default class when unlabeled); None for neutral traffic. An unknown
    label raises ``ValueError``: a misspelled class must not demote a
    request to the neutral tier."""
    name = qos if qos is not None else default_class_name()
    if not name:
        return None
    try:
        return classes[name]
    except KeyError:
        raise ValueError(
            f"unknown QoS class {name!r}; known: {sorted(classes)}"
        ) from None


def _batch_urgency(batch):
    """Sort key of one compatible batch: (best priority tier of its members,
    earliest deadline, oldest arrival). One urgent member promotes its
    whole batch."""
    prio = min(r.priority for r in batch)
    deadline = min((r.t_deadline for r in batch
                    if r.t_deadline is not None), default=float("inf"))
    return (prio, deadline, min(r.t_submit for r in batch))


def schedule(requests, max_k: int):
    """Group ``requests`` as :func:`~.coalescer.coalesce` does and order the
    batches by urgency. With one priority and no deadlines the order is
    the coalescer's (oldest member first)."""
    from .coalescer import coalesce
    batches = coalesce(requests, max_k)
    batches.sort(key=_batch_urgency)
    return batches


def shed_victim(pending, priority: int):
    """The pending request an arrival of ``priority`` may displace when the
    admission queue is full: the least urgent strictly-lower-priority one
    (highest tier; the newest breaks ties). None when nothing pending is
    strictly less urgent: equal priorities never shed each other."""
    worst = None
    for r in pending:
        if r.priority <= priority:
            continue
        if (worst is None or r.priority > worst.priority
                or (r.priority == worst.priority
                    and r.t_submit > worst.t_submit)):
            worst = r
    return worst


@dataclass(frozen=True)
class ScaleDecision:
    """One autoscale verdict: ``action`` in {hold, grow, shrink, rebalance};
    ``replica`` names the shrink target or the (busiest, idlest) pair;
    ``reason`` is the evidence line."""
    action: str
    replica: object = None
    reason: str = ""


@dataclass
class AutoscalePolicy:
    """Queue-wait-driven replica scaling policy, decisions only (JAX
    ``qos.py:157``): a ``queue_wait_p99_s`` above ``high_p99_s`` on any
    replica asks for a grow; below ``low_p99_s`` on every replica, a shrink
    down to ``min_replicas``; a busiest/idlest p99 ratio above
    ``rebalance_ratio`` (neither bound tripped), one session migration.
    Replicas without wait samples are neutral."""
    enabled: bool = True
    high_p99_s: float = 0.5
    low_p99_s: float = 0.01
    min_replicas: int = 1
    max_replicas: int = 8
    rebalance_ratio: float = 10.0

    @classmethod
    def from_options(cls) -> "AutoscalePolicy":
        """The policy from the options database (``-autoscale_*``)."""
        opt = global_options()
        p = cls()
        p.enabled = opt.get_bool("autoscale_enable", p.enabled)
        p.high_p99_s = opt.get_real("autoscale_high_p99", p.high_p99_s)
        p.low_p99_s = opt.get_real("autoscale_low_p99", p.low_p99_s)
        p.min_replicas = opt.get_int("autoscale_min_replicas",
                                     p.min_replicas)
        p.max_replicas = opt.get_int("autoscale_max_replicas",
                                     p.max_replicas)
        p.rebalance_ratio = opt.get_real("autoscale_rebalance_ratio",
                                         p.rebalance_ratio)
        return p

    def decide(self, replica_stats: dict) -> ScaleDecision:
        """``replica_stats``: replica name -> its ``SolveServer.stats()``.
        Returns exactly one :class:`ScaleDecision`."""
        if not self.enabled or not replica_stats:
            return ScaleDecision("hold", reason="autoscale disabled"
                                 if not self.enabled else "no replicas")
        p99 = {name: st.get("queue_wait_p99_s")
               for name, st in replica_stats.items()}
        sampled = {n: v for n, v in p99.items() if v is not None}
        n = len(replica_stats)
        hot = [nm for nm, v in sampled.items() if v > self.high_p99_s]
        if hot and n < self.max_replicas:
            worst = max(hot, key=lambda nm: sampled[nm])
            return ScaleDecision(
                "grow", reason=f"replica {worst!r} queue-wait p99 "
                f"{sampled[worst] * 1e3:.1f} ms > "
                f"{self.high_p99_s * 1e3:.1f} ms high watermark")
        if sampled and not hot:
            busiest = max(sampled, key=sampled.get)
            idlest = min(sampled, key=sampled.get)
            if (sampled[idlest] > 0
                    and sampled[busiest] / sampled[idlest]
                    > self.rebalance_ratio):
                return ScaleDecision(
                    "rebalance", replica=(busiest, idlest),
                    reason=f"p99 skew {sampled[busiest] * 1e3:.1f} ms "
                    f"({busiest!r}) vs {sampled[idlest] * 1e3:.1f} ms "
                    f"({idlest!r}) exceeds ratio {self.rebalance_ratio}")
            if (n > self.min_replicas
                    and all(v < self.low_p99_s for v in sampled.values())):
                return ScaleDecision(
                    "shrink", replica=idlest,
                    reason=f"every replica under the "
                    f"{self.low_p99_s * 1e3:.1f} ms low watermark "
                    f"(idlest: {idlest!r})")
        return ScaleDecision("hold", reason="within watermarks")
