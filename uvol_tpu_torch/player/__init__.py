"""The port's headless players: the facade `Player`, `V2Player` (on the
card unless the caller names the CPU, `device="cpu"`) and `V1Player`
(host work only: Corto geometry and the H.264/MP4 texture)."""

from uvol_tpu_torch.player.clock import PlaybackClock, VirtualClock  # noqa: F401
from uvol_tpu_torch.player.facade import Player  # noqa: F401
from uvol_tpu_torch.player.scheduler import (  # noqa: F401
    PrefetchState,
    V1RequestPacer,
    eviction_thresholds,
    get_current_frame,
    plan_prefetch,
)
from uvol_tpu_torch.player.v1 import V1FrameResult, V1Player  # noqa: F401
from uvol_tpu_torch.player.v2 import FrameResult, V2Player  # noqa: F401
