"""4x4 pose -> 6D (x, y, z, roll, pitch, yaw) conversion for robot consumers.

The port's own copy of foundationpose_tpu/io/pose6d.py (reference
src/transform.py:4-68), including its gimbal-lock
branches and the inches/degrees output units used by the NetworkTables robot
loop.
"""

from __future__ import annotations

import logging
import math

import numpy as np

METERS_TO_INCHES = 39.3701


class PoseTransformer:
    def __init__(self, to_inches=True, to_degrees=True):
        self.to_inches = to_inches
        self.to_degrees = to_degrees

    def transform_pose(self, center_pose):
        pose_6d = self._convert_pose_matrix_to_6d(np.asarray(center_pose))
        x, y, z, roll, pitch, yaw = pose_6d
        unit_pos = "inches" if self.to_inches else "meters"
        unit_rot = "degrees" if self.to_degrees else "radians"
        logging.info(
            "Object position (%s): x=%.4f y=%.4f z=%.4f", unit_pos, x, y, z
        )
        logging.info(
            "Object rotation (%s): roll=%.4f pitch=%.4f yaw=%.4f",
            unit_rot, roll, pitch, yaw,
        )
        return pose_6d

    def _convert_pose_matrix_to_6d(self, pose_matrix):
        x, y, z = pose_matrix[0, 3], pose_matrix[1, 3], pose_matrix[2, 3]
        roll, pitch, yaw = self._rotation_matrix_to_euler_angles(pose_matrix[:3, :3])
        if self.to_degrees:
            roll, pitch, yaw = map(math.degrees, (roll, pitch, yaw))
        if self.to_inches:
            x, y, z = (v * METERS_TO_INCHES for v in (x, y, z))
        return x, y, z, roll, pitch, yaw

    @staticmethod
    def _rotation_matrix_to_euler_angles(R):
        """ZYX (yaw-pitch-roll) extraction with gimbal-lock handling
        (reference transform.py:50-68)."""
        if abs(R[2, 0]) > 0.9999:
            yaw = 0.0
            if R[2, 0] < 0:
                pitch = math.pi / 2
                roll = math.atan2(R[0, 1], R[1, 1])
            else:
                pitch = -math.pi / 2
                roll = -math.atan2(R[0, 1], R[1, 1])
        else:
            pitch = -math.asin(R[2, 0])
            roll = math.atan2(R[2, 1] / math.cos(pitch), R[2, 2] / math.cos(pitch))
            yaw = math.atan2(R[1, 0] / math.cos(pitch), R[0, 0] / math.cos(pitch))
        return roll, pitch, yaw
