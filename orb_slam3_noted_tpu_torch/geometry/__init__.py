"""Lie-group geometry core (SO3 / SE3) and small-matrix linear algebra."""
