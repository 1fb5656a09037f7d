"""graft-lint: the async-hazard and invariant static-analysis plane.

Pure-stdlib (`ast` only) analyzer that
mechanically enforces the invariants the repo keeps re-learning by hand:

  loop-blocker         blocking syscalls reachable from a coroutine stall
                       the event loop for EVERY concurrent request
  orphan-task          a fire-and-forget create_task drops exceptions on
                       the floor and may be garbage-collected mid-flight
  swallowed-exception  `except Exception` bodies must log, re-raise,
                       count a metric, or carry an explicit pragma
  resource-discipline  metric families registered by an instance must be
                       unregistered by it; config knobs read anywhere
                       must be declared (and so validated) at load time

Distributed-correctness families:

  cancel-safety        awaits in finally:, swallowed CancelledError, and
                       cancel()-without-drain — the teardown traps behind
                       "breakers pinned open" convergence stalls
  lock-await           RPC / unbounded waits while holding an asyncio
                       mutex: cluster-wide convoys and deadlocks
  trust-boundary       pre-auth / peer-supplied values (claimed key ids,
                       gossiped digests) must pass _esc/validation before
                       metric labels, log f-strings, or paths
  wire-compat          digest keys, RPC frame meta keys and Migratable
                       markers are held against the reference package's
                       snapshot (script/wire_schema.json, read only: this
                       package speaks the reference's wire); CRDT classes
                       may only mutate state in __init__/merge*/update*

Accelerator families, for torch on a CUDA card (the reference's four,
by the same names, so pragmas and the catalogue carry over):

  host-sync            device->host sync points (.item()/.tolist()/
                       .cpu()/.numpy()/.to("cpu") or float()/int()/bool()
                       on a tensor on the card, and every .synchronize())
                       reachable from coroutines — the loop-blocker rule
                       for the device boundary
  recompile-hazard     kernel-wrapper launches whose batch never flowed
                       through an ops/bucketing.py pad helper, and Python
                       branching on a tensor's value in a def run under
                       CUDA-graph capture
  use-after-donation   cross-stream lifetime: a tensor allocated on one
                       stream and read under ``torch.cuda.stream(s)`` with
                       neither ``s.wait_stream`` nor ``t.record_stream(s)``
                       (torch has no donation; this is its hazard class)
  backend-gate         backend-string comparisons (platform names, a
                       tensor's .device.type) outside ops/telemetry.py,
                       and /codec/ dispatches on ``self._ec`` that don't
                       count block_codec_*{path}

Resolution: name-based plus receiver types learned from constructor
assignments (``self.x = Foo()``) and parameter annotations — calls like
``self.persister.save(...)`` resolve one level deep (no general type
inference).  The accelerator families share `device_model.py`: the
package's kernel wrappers and tensor placements, pad-to-bucket
provenance followed through wrapper calls, and CUDA-graph-captured defs.

`analyze(root, paths, rules, package=...)` lints `package` (default
garage_tpu_torch); the paths its rules single out (config, telemetry,
wire-defining modules) live under that package, so the generic families
also lint the reference package when asked to.  Run it as
``python -m garage_tpu_torch.analysis`` (tier-1 gated by
``tests/test_torch_analysis.py`` against
``garage_tpu_torch/analysis/lint_baseline.json``).  Pragma syntax:
``# graft-lint: allow-<kind>(<reason>)`` in a comment on the flagged
line or the line above.
"""

from .core import Project, Violation, analyze  # noqa: F401

__all__ = ["Project", "Violation", "analyze"]
