"""SLAM pipeline: map state, tracking, system facade."""
