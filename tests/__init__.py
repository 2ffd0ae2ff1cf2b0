"""Test package: a regular package, so that ``tests.<module>`` imports
resolve to this directory even where another ``tests`` package is
installed."""
