"""Runtime health: step-time straggler flagging and heartbeat liveness."""
