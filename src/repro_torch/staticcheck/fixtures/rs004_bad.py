"""RS004 must-fail fixture: ``XLA_FLAGS`` overwritten instead of appended.

The bug class: a script that sets the variable outright clobbers any
device-count or dump flag the caller had already exported.  Never imported
— the gate lints it and must report RS004.
"""
import os

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
