"""Raw-dataset preprocessing (CMU-MOSEI, CMU-MOSI) and media conversion:
host code, ffmpeg as a subprocess."""
