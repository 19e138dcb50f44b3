"""The telemetry name registry: every span and metric the port emits.

The port's own copy of ``mpi_petsc4py_example_tpu/telemetry/names.py``:
``NAMES`` maps every span, counter, gauge and histogram name to its kind and
a one-line description, key for key and kind for kind the JAX package's (the
multisplitting names are recorded by ``solvers/multisplit.py``). The spans
module and
the metrics registry validate against it at run time, so a misspelled name
raises instead of recording into a parallel universe.

``FLIGHT_FAULT_POINTS`` lists every fault point whose fired clauses reach
the flight recorder; it covers every key of ``resilience/faults.FAULT_POINTS``
(``tests/test_torch_telemetry.py`` holds the two against each other).

This module imports nothing.
"""

# name -> (kind, description); kind in {"span", "counter", "gauge",
# "histogram"}. Keep entries grouped by subsystem, alphabetical within.
NAMES = {
    # ---- spans: KSP (solvers/ksp.py) ----
    "ksp.solve": ("span", "one KSP.solve call: setup -> dispatch -> fetch "
                          "(re-entries nest as child ksp.solve spans)"),
    "ksp.solve_many": ("span", "one batched KSP.solve_many block launch"),
    "ksp.setup": ("span", "PC set_up + solve-program build/AOT-load"),
    "ksp.dispatch": ("span", "the compiled solve program's execute call"),
    "ksp.fetch": ("span", "the batched D2H result fetch"),
    "ksp.verify": ("span", "the true-residual gate decision + re-entries"),
    "ksp.autoselect": ("span", "-ksp_reduction_auto: measured-latency "
                               "reduction-plan selection at KSP.setUp "
                               "(solvers/autoselect.py)"),
    # ---- spans: PC / EPS / refinement ----
    "pc.setup": ("span", "preconditioner factor build/placement (covers "
                         "the MG/GAMG hierarchy build — the MG entry)"),
    "eps.solve": ("span", "one EPS.solve eigensolve"),
    "refine.outer": ("span", "RefinedKSP outer fp64 refinement loop"),
    "refine.step": ("span", "one outer correction step (inner solve + "
                            "fp64 residual + accumulate)"),
    # ---- spans: resilience (resilience/retry.py) ----
    "resilient.solve": ("span", "resilient_solve/_many wrapper: children "
                                "are the recovery-ladder stages"),
    "resilient.backoff": ("span", "deterministic backoff wait before a "
                                  "same-mesh retry"),
    "resilient.rebuild": ("span", "operator rebuild from the checkpoint"),
    "resilient.rollback": ("span", "DETECTED_SDC immediate re-entry from "
                                   "the verified iterate"),
    "resilient.shrink": ("span", "elastic mesh-shrink escalation (attrs: "
                                 "old/new devices, resumed_iteration)"),
    "resilient.regrow": ("span", "elastic mesh RE-GROW escalation after a "
                                 "heal (attrs: old/new devices, "
                                 "resumed_iteration)"),
    "resilient.verify": ("span", "post-recovery independent true-residual "
                                 "verification"),
    # ---- spans: serving (serving/server.py + serving/fleet.py) ----
    "serving.coalesce": ("span", "QoS-scheduling one queue snapshot into "
                                 "urgency-ordered compatible batches"),
    "serving.dispatch": ("span", "one coalesced block dispatch (root span "
                                 "on the dispatcher thread)"),
    "serving.request": ("span", "one request submit -> resolve, linked to "
                                "its batch via the batch_span attr"),
    "serving.regrow": ("span", "server-wide adoption of a re-grown mesh "
                               "after a heal (every resident session "
                               "rebuilt on the larger geometry)"),
    "serving.persistent_launch": ("span", "one persistent_serve launch: "
                                          "up to Q staged request slots "
                                          "resolved out of one resident "
                                          "multi-request program "
                                          "(serving/persistent.py)"),
    "fleet.migrate": ("span", "one session migration between replicas: "
                              "drain -> checkpoint -> re-register -> "
                              "replay"),
    "fleet.scale": ("span", "one executed autoscale decision "
                            "(grow/shrink/rebalance)"),
    # ---- spans: multi-host transport (serving/transport.py + remote.py) ----
    "rpc.call": ("span", "one client RPC call end to end: every send "
                         "attempt, backoff and idempotent retry under "
                         "one deadline (attrs: method, host, attempts)"),
    "fleet.failover": ("span", "one confirmed-host-loss re-home: every "
                               "session re-registered on a survivor "
                               "from its last shipped checkpoint "
                               "(attrs: host, sessions, "
                               "resumed_iteration)"),
    "fleet.reconcile": ("span", "one post-partition placement "
                                "reconcile: resident tables gathered, "
                                "highest-epoch/authoritative winner "
                                "kept, orphan registrations removed"),
    # ---- spans: async multisplitting (solvers/multisplit.py) ----
    "multisplit.solve": ("span", "one asynchronous two-stage multisplit "
                                 "solve: block threads + bounded-staleness "
                                 "supervisor to the consistent-cut "
                                 "convergence decision"),
    # ---- counters ----
    "dispatch.programs": ("counter", "compiled-program launches by "
                                     "program kind (ksp/ksp_many/"
                                     "megasolve/...); each launch also "
                                     "increments the 'dispatches' attr "
                                     "of the current root span — the "
                                     "megasolve one-launch gate's "
                                     "measurement"),
    "solve.count": ("counter", "solves by event label (KSPSolve(...), "
                               "EPSSolve(...), ...)"),
    "solve.iterations": ("counter", "total solver iterations"),
    "sync.count": ("counter", "host<->device sync points by kind"),
    "fault.count": ("counter", "fired fault-injection clauses by point"),
    "abft.checks": ("counter", "ABFT checksum checks performed"),
    "abft.detections": ("counter", "silent-corruption detectors fired"),
    "abft.replacements": ("counter", "in-program residual replacements"),
    "sstep.demotions": ("counter", "s-step solves demoted to classic CG "
                                   "(CA-CG basis-restart budget "
                                   "-ksp_sstep_max_replacements "
                                   "exhausted)"),
    "serving.requests": ("counter", "real requests dispatched (padding "
                                    "excluded)"),
    "serving.batches": ("counter", "coalesced block dispatches"),
    "serving.padded_cols": ("counter", "zero columns added by pow2 "
                                       "padding"),
    "serving.width": ("counter", "dispatched batches by real width "
                                 "(the width histogram)"),
    "serving.rejected": ("counter", "submissions rejected by the "
                                    "admission queue bound"),
    "serving.expired": ("counter", "requests expired by their dispatch "
                                   "deadline"),
    "serving.shed": ("counter", "bulk requests shed (resolved with the "
                                "typed overload error) to admit more "
                                "urgent traffic"),
    "qos.requests": ("counter", "admitted requests by QoS class "
                                "('default' for unlabeled)"),
    "fleet.migrations": ("counter", "executed session migrations between "
                                    "replicas"),
    "fleet.scale_decisions": ("counter", "autoscale decisions by action "
                                         "(grow/shrink/rebalance/hold)"),
    "rpc.retries": ("counter", "RPC send attempts beyond the first "
                               "(same idempotency key re-sent after a "
                               "drop/timeout) by method"),
    "rpc.duplicates": ("counter", "duplicate deliveries collapsed by the "
                                  "host-side idempotency cache (joined "
                                  "in-flight or served from the result "
                                  "cache — never re-executed)"),
    "fleet.failovers": ("counter", "confirmed host losses re-homed onto "
                                   "survivors"),
    "fleet.lease_misses": ("counter", "lease renewals that found a host "
                                      "unreachable (suspected after "
                                      "-fleet_transport_suspect_after, "
                                      "confirmed dead after "
                                      "-fleet_transport_confirm_after)"),
    "multisplit.step": ("counter", "completed async outer steps (inner "
                                   "solve + publish) by block"),
    "multisplit.resyncs": ("counter", "bounded-staleness re-syncs: a block "
                                      "waited for a partner over the "
                                      "-multisplit_max_stale bound"),
    "multisplit.block_lost": ("counter", "blocks degraded to frozen-stale "
                                         "after a device loss (each later "
                                         "re-homed by the elastic path)"),
    "elastic.mesh_shrinks": ("counter", "executed degraded-mesh rebuilds"),
    "elastic.mesh_regrows": ("counter", "executed mesh RE-GROW rebuilds "
                                        "(healed capacity re-adopted)"),
    "kernel.model_bytes": ("counter", "useful roofline-model bytes by "
                                      "kernel"),
    "kernel.seconds": ("counter", "measured device seconds by kernel"),
    "kernel.episodes": ("counter", "delta-method episodes by kernel"),
    "collective.per_iter_seconds": ("counter", "summed per-iteration wall "
                                               "by solver-loop label"),
    "collective.episodes": ("counter", "collective-latency episodes by "
                                       "label"),
    # ---- gauges ----
    "collective.reduce_sites": ("gauge", "psum/all-reduce sites per "
                                         "iteration by solver-loop label"),
    "kernel.achieved_gbps": ("gauge", "achieved effective bandwidth by "
                                      "kernel (model bytes / measured s)"),
    "solve.programs": ("gauge", "jit-compiled solver programs held "
                                "(KSP + EPS caches)"),
    "serving.queue_depth": ("gauge", "pending requests at last submit"),
    "fleet.replicas": ("gauge", "live server replicas behind the router"),
    "fleet.live_hosts": ("gauge", "transport hosts currently holding a "
                                  "fresh lease (suspected/confirmed "
                                  "hosts excluded)"),
    "autoselect.psum_latency_us": ("gauge", "measured (or probe-cached) "
                                           "per-reduce-site latency of "
                                           "the mesh, microseconds"),
    # ---- histograms (fixed buckets — metrics.py) ----
    "solve.latency_seconds": ("histogram", "end-to-end wall per solve"),
    "solve.per_iter_seconds": ("histogram", "wall per solver iteration "
                                            "(the -log_view latency row)"),
    "serving.queue_wait_seconds": ("histogram", "submit -> dispatch wait "
                                                "per request"),
    "multisplit.stale_age": ("histogram", "staleness age (versions behind "
                                          "the reader) of every boundary "
                                          "read — the -log_view staleness "
                                          "row"),
    "dispatch.requests_per_launch": ("histogram",
                                     "requests amortized into one "
                                     "persistent_serve launch — the "
                                     "-log_view requests-per-launch row "
                                     "(≫1 means the resident program is "
                                     "paying ≪1 dispatch/request)"),
    "rpc.call_seconds": ("histogram", "client RPC call wall including "
                                      "every retry and backoff under "
                                      "the call deadline — the retry "
                                      "tail is the interesting bucket "
                                      "mass"),
}

# Fault points the flight recorder records events for. Covers every key of
# resilience/faults.FAULT_POINTS (resilience/faults.py routes every fired
# clause through telemetry.flight.record_fault).
FLIGHT_FAULT_POINTS = (
    "ksp.solve",
    "ksp.program",
    "ksp.result",
    "eps.solve",
    "comm.put",
    "comm.fetch",
    "comm.psum",
    "spmv.result",
    "pc.apply",
    "device.lost",
    "comm.delay",
    "exchange.put",
    "rpc.send",
    "rpc.recv",
)


def name_kind(name: str) -> str:
    """The registered kind of ``name``; raises ``KeyError`` (with the
    registration hint) for unknown names."""
    try:
        return NAMES[name][0]
    except KeyError:
        raise KeyError(
            f"telemetry name {name!r} is not registered in "
            "telemetry/names.NAMES — register it (kind + description) "
            "before emitting it") from None
