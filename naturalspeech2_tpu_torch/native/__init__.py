"""Native host code of the port: the audio decoder (`audioio`)."""
