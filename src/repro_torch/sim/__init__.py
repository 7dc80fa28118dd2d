"""The event engine of the asynchronous simulator (so far its event core,
which the serve swarm runs on)."""
