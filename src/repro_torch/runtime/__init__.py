"""Runtime health: step-time straggler flagging, heartbeat liveness, and
the Supervisor's restore-and-retry on a failed training step."""
