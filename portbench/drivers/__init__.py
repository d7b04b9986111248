"""Traffic drivers: one module per way of calling the program, named by
a traffic file's "driver" key (`traffic/<traffic>.json`).  A module has
a class `Driver(cell, seed, device)` whose construction is the set-up
(the program built at the cell's shape and warmed up on data of its
own), and

    data(k) -> the inputs of request group k of the window, drawn from
               (seed, k)
    serve(data) -> the program's answers, each with x, s, z,
                   status.name and iterations
    close() -> frees the program's state
    struct -> the problem structure (as a generator's `structure`)
              that the check reads

The harness times `serve` alone, and runs the groups one after another
for the window (a closed loop)."""
