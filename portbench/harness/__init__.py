"""The harness: specification, scene, the port's problem, trace and check."""
