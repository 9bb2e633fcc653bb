"""The serving core: sections, buckets, the fleet batch and the tick loop."""
