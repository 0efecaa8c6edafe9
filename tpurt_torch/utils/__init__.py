"""Aux subsystems: config and measured live-wave caps."""
