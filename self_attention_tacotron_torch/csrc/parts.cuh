// A source built as several translation units at once (utils/cuda_build.py,
// KERNEL_PARTS): nvcc compiles part SATT_PART of SATT_PARTS with its share of the
// kernel instantiations, and the parts are linked into one library. Each part
// enrols the addresses of its kernels in the library's table when the library is
// loaded; part 0 also holds the table, the launches and the C interface. Built as
// one unit (``nvcc`` on the file alone), the single part is part 0 of 1.
#pragma once

#ifndef SATT_PARTS
#define SATT_PARTS 1
#endif
#ifndef SATT_PART
#define SATT_PART 0
#endif

// the part an instantiation is compiled in, from the index of its variant and a
// mix of its flags that spreads the costly ones over the parts
constexpr bool in_this_part(int mix) { return mix % SATT_PARTS == SATT_PART; }

// a table entry's enrolment, visible to the parts of one library alone
#define SATT_HIDDEN __attribute__((visibility("hidden")))
