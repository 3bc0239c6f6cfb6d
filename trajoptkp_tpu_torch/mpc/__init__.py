from .sync import (MPCRunResult, gravity_compensation_ctrl,  # noqa: F401
                   make_lane_sync_mpc, make_lane_sync_mpc_host, make_sync_mpc)
