"""Protocol math of the port: schedules, masks, the stream engine, costs and
the round (``fedavg``)."""
