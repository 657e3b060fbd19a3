"""The benchmark's yardstick and harness."""
