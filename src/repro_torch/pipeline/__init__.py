"""Inter-layer pipeline parallelism for second-order training
(counterpart of ``repro.pipeline``).

RePAST trains on a PipeLayer-style substrate: consecutive batches
stream through per-layer crossbar pipelines while the INV engine runs
second-order work beside them (paper Sec. II-C, VI). This package is
the mesh image of that execution model — a ``stage`` axis over which
the layer stack is partitioned, with microbatches flowing through a
static schedule:

  stages      host-side balanced contiguous partition of the *atom*
              stack — layers, hybrid pattern units (ragged tail on the
              last stage), or whisper enc/dec layers — by exact
              min-max DP; embedding/head pinned to the first/last
              stage
  schedule    GPipe and 1F1B tick grids built host-side, and their
              executor: each stage rank walks its column of the grid
              (forward, remat-style backward from the stashed stage
              input, one all_gather transfer a tick over the ``stage``
              submesh), with tensor and expert parallelism inside a
              stage over ``model``; and the statistics pass through
              the stages
  microbatch  the (n_micro, mb, ...) batch splitter, shared with
              gradient accumulation (launch/steps)
  stash       static slot allocation for the activation stashes +
              weight-version ledger enforcing PipeLayer's exactly-once
              update semantics
  kfac_glue   stage-local K-FAC factor map + the policy that schedules
              the async SOI inverse refresh into fill/drain bubbles

Entry point: ``launch/steps.make_pipeline_step`` (``--pp N`` /
``--pp-schedule`` on the training CLI); ``pp=1`` returns
``make_train_step`` itself.
"""

from repro_torch.pipeline.microbatch import split_microbatches  # noqa: F401
from repro_torch.pipeline.schedule import (  # noqa: F401
    SCHEDULES,
    Schedule,
    make_pipeline_grads_fn,
    make_schedule,
)
from repro_torch.pipeline.stages import (  # noqa: F401
    StagePartition,
    partition_stages,
)
from repro_torch.pipeline.stash import (  # noqa: F401
    ExactlyOnceViolation,
    SlotAllocator,
    StashPlan,
    WeightStash,
)
from repro_torch.pipeline import kfac_glue  # noqa: F401
