"""Architecture configs the port serves (copies of ``repro.configs``)."""
