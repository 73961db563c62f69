"""NetworkTables schema + pose publisher for the robot loop.

The port's own copy of foundationpose_tpu/io/nt.py. Schema constants follow
the reference src/nt_schema.py:4-32; the publisher realizes main.py:81-102
(connect, publish the 6D pose string and a timestamp at
NT_UPDATE_FREQUENCY). Without the ``pynetworktables`` package the publisher
logs the pose instead — the schema and call surface are unchanged.
"""

from __future__ import annotations

import logging
import time

# Root table name
ROOT_TABLE = "SavaRobot"

COMMANDS_TABLE = f"{ROOT_TABLE}/Commands"
STATUS_TABLE = f"{ROOT_TABLE}/Status"
VISION_TABLE = f"{ROOT_TABLE}/Vision"
DIAGNOSTICS_TABLE = f"{ROOT_TABLE}/Diagnostics"

# 6D pose (x,y,z,roll,pitch,yaw) as comma-separated string
FOUNDATION_POSE = f"{VISION_TABLE}/FoundationPose"

ARM_TARGET_POSITION = f"{COMMANDS_TABLE}/ArmTargetPosition"
ARM_COMMAND_READY = f"{COMMANDS_TABLE}/ArmCommandReady"
ARM_CURRENT_POSITION = f"{STATUS_TABLE}/ArmCurrentPosition"
ARM_STATE = f"{STATUS_TABLE}/ArmState"
ARM_ERROR = f"{STATUS_TABLE}/ArmError"
ARM_COMMAND_RECEIVED = f"{STATUS_TABLE}/ArmCommandReceived"
ARM_COMMAND_EXECUTED = f"{STATUS_TABLE}/ArmCommandExecuted"

COMMAND_TIMESTAMP = f"{COMMANDS_TABLE}/Timestamp"
VISION_TIMESTAMP = f"{VISION_TABLE}/Timestamp"

NT_UPDATE_FREQUENCY = 50.0  # Hz
EXPECTED_LATENCY_MS = 20.0


class PosePublisher:
    """Publish 6D poses to NetworkTables (or log them when NT is absent)."""

    def __init__(self, server="10.0.0.2", connect_timeout_s=10.0):
        self.server = server
        self.nt = None
        self.table = None
        try:
            from networktables import NetworkTables  # type: ignore

            NetworkTables.initialize(server=server)
            t0 = time.time()
            while not NetworkTables.isConnected():
                if time.time() - t0 > connect_timeout_s:
                    logging.warning("NetworkTables connect timeout (%s)", server)
                    break
                time.sleep(0.1)
            self.nt = NetworkTables
            self.table = NetworkTables.getTable(VISION_TABLE)
        except ImportError:
            logging.info(
                "pynetworktables not installed; PosePublisher runs in log-only mode"
            )

    def publish_pose(self, pose_6d):
        value = ",".join(f"{v:.6f}" for v in pose_6d)
        ts = time.time()
        if self.table is not None:
            self.table.putString("FoundationPose", value)
            self.table.putNumber("Timestamp", ts)
        else:
            logging.info("[NT:%s] %s @ %.3f", FOUNDATION_POSE, value, ts)
        return value
