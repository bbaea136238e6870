"""Host tools: tracing and timing, roofline accounting, file IO and noise
injection."""
