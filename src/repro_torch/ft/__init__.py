"""The port's fault-tolerance policies (`elastic`): checkpoint/restart
settings, straggler detection and a failure injector for tests."""
