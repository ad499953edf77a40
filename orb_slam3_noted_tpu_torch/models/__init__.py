"""Camera models (pinhole; Kannala-Brandt waits for the fisheye slice)."""
